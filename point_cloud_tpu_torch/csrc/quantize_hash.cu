// quantize_hash.cu — B2, the dedup pass's front end, for Hopper (sm_90a).
//
// Replaces the front half of the reference's fused pass,
// point_cloud_tpu/ops/dedup.py: hex_keys (:184-225), _mix/_hash_cols
// (:168-181) and the masking of _hash_sort (:228-260), with the gather of
// _dedup_resident_body (:428-452) in its gather mode. XLA fuses these into
// one program; the port ran them as some sixty eager torch launches.
//
// One thread a row, nothing shared between rows. A row reads its three
// f32 coordinates and its valid byte (gather mode: its i32 source, then
// the coordinates from ``resident`` for a source >= 0, else from
// ``extras`` at ~source; padding, i32::MAX, reads resident row 0) and
// writes the four i32 columns in the layout sort4 takes:
//   cell hash (clamped to 0x7FFFFFFE; padding i32::MAX),
//   slot hash (padding 0),
//   distance bits (the f32 distance's bits; padding i32::MAX),
//   arrival (the row index).
// Optional outputs (null pointers skip them): the keys (cell index and
// slot, 3 i32 each, and the f32 distance, unmasked) for the full pass, and
// in gather mode the gathered (n, 3) positions for B3. The arithmetic is
// hex_keys.cuh's: IEEE f32 in the torch twins' order, bit for bit.
//
// What bounds it: bytes, 29 a row (12 B positions and 1 B valid read,
// 16 B of columns written): 9.1 us at 2^20 rows at 3.35 TB/s. The gather
// mode adds 4 B of source and 12 B of gathered positions a row; the keys
// add 28 B. A row's arithmetic (8 IEEE divisions, ~120 other operations)
// is far below the byte time on 132 SMs.

#include <cuda_runtime.h>

#include "hex_keys.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) quantize_hash_kernel(
    const float* __restrict__ positions, const unsigned char* __restrict__ valid,
    const int* __restrict__ src, const float* __restrict__ resident,
    const float* __restrict__ extras, const float* __restrict__ cell_size,
    const float* __restrict__ radius, long long n, int* __restrict__ cell_hash,
    int* __restrict__ slot_hash, int* __restrict__ dist_bits,
    int* __restrict__ arrival, int* __restrict__ cell_idx,
    int* __restrict__ sub_idx, float* __restrict__ dist,
    float* __restrict__ pos_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* row;
  bool ok;
  if (src != nullptr) {
    const int s = __ldg(src + i);
    ok = s != INT_MAX;
    row = s >= 0 ? resident + 3LL * (ok ? s : 0) : extras + 3LL * ~s;
  } else {
    row = positions + 3 * i;
    ok = __ldg(valid + i) != 0;
  }
  const float px = __ldg(row), py = __ldg(row + 1), pz = __ldg(row + 2);
  if (pos_out != nullptr) {
    pos_out[3 * i] = px;
    pos_out[3 * i + 1] = py;
    pos_out[3 * i + 2] = pz;
  }
  const pc_hex::Keys k =
      pc_hex::hex_keys<true>(px, py, pz, __ldg(cell_size), __ldg(radius));
  int ch, sh;
  pc_hex::hashes(k, &ch, &sh);
  cell_hash[i] = ok ? ch : INT_MAX;  // padding sorts last
  slot_hash[i] = ok ? sh : 0;
  dist_bits[i] = ok ? __float_as_int(k.dist) : INT_MAX;
  arrival[i] = static_cast<int>(i);
  if (cell_idx != nullptr) {
    for (int c = 0; c < 3; ++c) {
      cell_idx[3 * i + c] = k.cell[c];
      sub_idx[3 * i + c] = k.sub[c];
    }
    dist[i] = k.dist;
  }
}

}  // namespace

// Returns a cudaError_t. Exactly one of ``positions`` (with ``valid``) and
// ``src`` (with ``resident`` and ``extras``) is given; ``cell_idx``,
// ``sub_idx`` and ``dist`` are all given or all null. n in [1, 2^31).
extern "C" int pc_quantize_hash(const float* positions, const unsigned char* valid,
                                const int* src, const float* resident,
                                const float* extras, const float* cell_size,
                                const float* radius, long long n, int* cell_hash,
                                int* slot_hash, int* dist_bits, int* arrival,
                                int* cell_idx, int* sub_idx, float* dist,
                                float* pos_out, void* stream_handle) {
  if (n < 1 || n > INT_MAX || (positions == nullptr) == (src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  quantize_hash_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream_handle)>>>(
      positions, valid, src, resident, extras, cell_size, radius, n, cell_hash,
      slot_hash, dist_bits, arrival, cell_idx, sub_idx, dist, pos_out);
  return static_cast<int>(cudaGetLastError());
}
