// quantize_hash.cu — B2, the dedup pass's front end, for Hopper (sm_90a),
// as the load stage of sort4's tile kernel.
//
// Replaces the front half of the reference's fused pass,
// point_cloud_tpu/ops/dedup.py: hex_keys (:184-225), _mix/_hash_cols
// (:168-181) and the masking of _hash_sort (:228-260), with the gather of
// _dedup_resident_body (:428-452) in its gather mode, and the sort that
// follows them (dispatch_sort4, :116-144). XLA fuses these into one
// program; the port ran them as some sixty eager torch launches.
//
// A row reads its three f32 coordinates and its valid byte (gather mode:
// its i32 source, then the coordinates from ``resident`` for a source >= 0,
// else from ``extras`` at ~source; padding, i32::MAX, reads resident row 0)
// and gives the four i32 columns sort4 sorts:
//   cell hash (clamped to 0x7FFFFFFE; padding i32::MAX),
//   slot hash (padding 0),
//   distance bits (the f32 distance's bits; padding i32::MAX),
//   arrival (the row index).
// Optional outputs at the row's own index: the keys (cell index and slot,
// 3 i32 each, and the f32 distance, unmasked) for the full pass, and in
// gather mode the gathered (n, 3) positions for B3. The arithmetic is
// hex_keys.cuh's: IEEE f32 in the torch twins' order, bit for bit, with
// the divisors' reciprocals taken once (pc_hex::Grid), not once a row.
//
// quantize_tile is sort4's tile sort (sort4_tile.cuh) with B2 as its row
// loader: each thread computes the keys of its 8 rows in registers, eight
// independent chains, and the block sorts them; pc_quantize_sort4 then
// runs sort4's merge passes. The columns never reach memory before the
// first merge.
//
// What bounds it: bytes. As a function it reads 13 B a row and writes the
// 16 B of sorted columns (plus the merge passes' traffic, mostly in L2);
// the gather mode adds 4 B of source and 12 B of gathered positions a
// row, the keys 28 B. A row's arithmetic (~120 operations; its 8
// divisions a multiply, two fmas and a range check each, with no branch)
// is far below the byte time on 132 SMs.

#include <cuda_runtime.h>

#include "hex_keys.cuh"
#include "sort4_tile.cuh"

namespace {

constexpr int kThreads = 256;

struct Front {
  int cell_hash, slot_hash, dist_bits;
  pc_hex::Keys keys;
};

// Row i's position and whether it is real: from ``positions``/``valid``,
// or, in gather mode (``src`` given), from ``resident``/``extras``.
template <bool kGather>
__device__ __forceinline__ bool fetch(
    long long i, const float* __restrict__ positions,
    const unsigned char* __restrict__ valid, const int* __restrict__ src,
    const float* __restrict__ resident, const float* __restrict__ extras,
    float* p) {
  const float* row;
  bool ok;
  if constexpr (kGather) {
    const int s = __ldg(src + i);
    ok = s != INT_MAX;
    row = s >= 0 ? resident + 3LL * (ok ? s : 0) : extras + 3LL * ~s;
  } else {
    row = positions + 3 * i;
    ok = __ldg(valid + i) != 0;
  }
  p[0] = __ldg(row);
  p[1] = __ldg(row + 1);
  p[2] = __ldg(row + 2);
  return ok;
}

// The sort columns of a row's keys, padding sentinels applied when not ok.
__device__ __forceinline__ Front front(const pc_hex::Keys& keys, bool ok) {
  Front f;
  f.keys = keys;
  int ch, sh;
  pc_hex::hashes(keys, &ch, &sh);
  f.cell_hash = ok ? ch : INT_MAX;  // padding sorts last
  f.slot_hash = ok ? sh : 0;
  f.dist_bits = ok ? __float_as_int(keys.dist) : INT_MAX;
  return f;
}

__device__ __forceinline__ void store_keys(long long i, const pc_hex::Keys& k,
                                           int* cell_idx, int* sub_idx,
                                           float* dist) {
  for (int c = 0; c < 3; ++c) {
    cell_idx[3 * i + c] = k.cell[c];
    sub_idx[3 * i + c] = k.sub[c];
  }
  dist[i] = k.dist;
}

__device__ __forceinline__ void store_position(long long i, const float* p,
                                               float* pos_out) {
  pos_out[3 * i] = p[0];
  pos_out[3 * i + 1] = p[1];
  pos_out[3 * i + 2] = p[2];
}

// sort_tile's loader: a thread's keys, (cell hash, slot hash, distance
// bits, arrival = the row), from its rows' positions; in gather mode it
// also stores the gathered positions, with kKeys the rows' keys. The 8
// rows are computed first with the branch-free quotient (FastDiv), as
// independent chains; a row that left its range (rare: no finite
// coordinate of a real cloud does) is computed again with __fdiv_rn.
template <bool kGather, bool kKeys>
struct FrontLoader {
  const float* positions;
  const unsigned char* valid;
  const int* src;
  const float* resident;
  const float* extras;
  pc_hex::Grid grid;
  int* cell_idx;
  int* sub_idx;
  float* dist;
  float* pos_out;

  // row r's key and, with kKeys, its stored keys; ``in``: r is a row of
  // the array (else the key is all ones and nothing is stored)
  template <class Div>
  __device__ __forceinline__ pc_tile::Key key(long long r, bool in,
                                              const float* p, bool ok,
                                              Div& div) const {
    const pc_hex::Keys keys =
        pc_hex::hex_keys<true>(p[0], p[1], p[2], grid, div);
    if constexpr (kKeys) {
      if (in) store_keys(r, keys, cell_idx, sub_idx, dist);
    }
    const Front f = front(keys, ok);
    return in ? pc_tile::make_key(f.cell_hash, f.slot_hash, f.dist_bits,
                                  static_cast<int>(r))
              : make_ulonglong2(~0ull, ~0ull);
  }

  __device__ __forceinline__ void fill(pc_tile::Key (&k)[pc_tile::kItems],
                                       long long base, int rows) const {
    bool fast = true;
#pragma unroll
    for (int j = 0; j < pc_tile::kItems; ++j) {
      const int i = j * pc_tile::kThreads + threadIdx.x;
      const bool in = i < rows;
      const long long r = base + (in ? i : 0);
      float p[3];
      const bool ok = fetch<kGather>(r, positions, valid, src, resident,
                                     extras, p);
      if constexpr (kGather) {
        if (in) store_position(r, p, pos_out);
      }
      pc_hex::FastDiv div{grid.fast};
      k[j] = key(r, in, p, ok, div);
      fast = fast & div.ok;
    }
    if (fast) return;
    // unrolled too: an index into k known only at run time would put the
    // tile's keys in local memory for the whole sort
#pragma unroll
    for (int j = 0; j < pc_tile::kItems; ++j) {
      const int i = j * pc_tile::kThreads + threadIdx.x;
      const bool in = i < rows;
      const long long r = base + (in ? i : 0);
      float p[3];
      const bool ok = fetch<kGather>(r, positions, valid, src, resident,
                                     extras, p);
      pc_hex::IeeeDiv div;
      k[j] = key(r, in, p, ok, div);
    }
  }
};

// kMinBlocks blocks an SM: 4 (at most 64 registers a thread, as
// sort4_tile fits) where the tiles need four an SM to be one wave, 2 (at
// most 128) where they need two or fewer: the rows' hex math then has
// registers for more of its chains at once (measured: PERF.md).
template <bool kGather, bool kKeys, int kMinBlocks>
__global__ void __launch_bounds__(pc_tile::kThreads, kMinBlocks) quantize_tile(
    const float* __restrict__ positions, const unsigned char* __restrict__ valid,
    const int* __restrict__ src, const float* __restrict__ resident,
    const float* __restrict__ extras, const float* __restrict__ cell_size,
    const float* __restrict__ radius, int* __restrict__ o1,
    int* __restrict__ o2, int* __restrict__ o3, int* __restrict__ o4,
    int rows, int* __restrict__ cell_idx, int* __restrict__ sub_idx,
    float* __restrict__ dist, float* __restrict__ pos_out) {
  __shared__ pc_tile::Key s[pc_tile::kShared];  // 36 KB
  const FrontLoader<kGather, kKeys> load{
      positions, valid, src, resident, extras,
      pc_hex::make_grid(__ldg(cell_size), __ldg(radius)),
      cell_idx, sub_idx, dist, pos_out};
  pc_tile::sort_tile(load, s, o1, o2, o3, o4, rows);
}

// Every f32 bit pattern as a numerator over each of the five divisors of
// ``count`` (cell size, radius) pairs (make_grid's four and 3), through
// FastDiv as hex_keys runs it: ``taken`` counts the numerators it takes
// (its flag stays set), ``bad`` those of them whose quotient differs in
// its bits from __fdiv_rn's, ``first_bad`` the smallest such numerator
// bit pattern (0xFFFFFFFF: none). A numerator it does not take is
// divided by __fdiv_rn itself in the kernels.
__global__ void division_check_kernel(const float* __restrict__ cell_size,
                                      const float* __restrict__ radius,
                                      int count,
                                      unsigned long long* __restrict__ bad,
                                      unsigned* __restrict__ first_bad,
                                      unsigned long long* __restrict__ taken) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (int g = 0; g < count; ++g) {
    const pc_hex::Grid grid = pc_hex::make_grid(cell_size[g], radius[g]);
    const pc_hex::Divisor divs[5] = {grid.cell, grid.x, grid.y, grid.h,
                                     pc_hex::three()};
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      unsigned long long wrong = 0, took = 0;
      unsigned first = 0xFFFFFFFFu;
      for (unsigned long long a =
               static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
               threadIdx.x;
           a < (1ULL << 32); a += stride) {
        const float x = __uint_as_float(static_cast<unsigned>(a));
        pc_hex::FastDiv fast{grid.fast};
        const float q = fast(x, divs[d]);
        if (fast.ok) {
          ++took;
          if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(x, divs[d].b))) {
            ++wrong;
            first = min(first, static_cast<unsigned>(a));
          }
        }
      }
      atomicAdd(taken + 5 * g + d, took);
      if (wrong) {
        atomicAdd(bad + 5 * g + d, wrong);
        atomicMin(first_bad + 5 * g + d, first);
      }
    }
  }
}

// FastDiv against __fdiv_rn on every numerator significand over
// ``count`` divisor significands, first + j * stride for j < count: a
// block a divisor b in [1, 2), its threads every numerator a in [1, 2).
// Scaling a and b by powers of two inside the helper's range scales q0,
// the remainder and the quotient exactly (each stays normal or exact),
// and a negative operand flips every sign, so these pairs stand for every
// numerator and divisor the helper takes. ``bad`` counts the pairs whose
// bits differ, ``first_bad`` (all ones: none) the smallest pair as
// (divisor bits << 32) | numerator bits.
__global__ void __launch_bounds__(kThreads) division_sweep_kernel(
    unsigned first, unsigned stride, unsigned long long* __restrict__ bad,
    unsigned long long* __restrict__ first_bad) {
  const unsigned mb = first + blockIdx.x * stride;
  const pc_hex::Divisor d = pc_hex::divisor(__uint_as_float(0x3F800000u | mb));
  unsigned wrong = 0u, first_a = 0xFFFFFFFFu;
  for (unsigned ma = threadIdx.x; ma < (1u << 23); ma += kThreads) {
    const float a = __uint_as_float(0x3F800000u | ma);
    pc_hex::FastDiv fast{true};
    if (__float_as_uint(fast(a, d)) != __float_as_uint(__fdiv_rn(a, d.b)) ||
        !fast.ok) {
      ++wrong;
      first_a = min(first_a, ma);
    }
  }
  if (wrong) {
    atomicAdd(bad, static_cast<unsigned long long>(wrong));
    atomicMin(first_bad,
              (static_cast<unsigned long long>(0x3F800000u | mb) << 32) |
                  (0x3F800000u | first_a));
  }
}

}  // namespace

// B2 and sort4 in one: the sorted columns (cell hash, slot hash, distance
// bits, arrival) into (o1..o4), with (t1..t4) as scratch of the same
// length, as pc_sort4 of B2's unsorted columns would leave them. Exactly
// one of ``positions`` (with ``valid``) and ``src`` (with ``resident``,
// ``extras`` and ``pos_out``, which gets the gathered rows) is given;
// ``cell_idx``, ``sub_idx`` and ``dist`` (the unsorted keys) are all given
// or all null, and only without ``src``. n is a power of two in
// [2^10, 2^30]. Returns cudaGetLastError() after each launch.
extern "C" int pc_quantize_sort4(
    const float* positions, const unsigned char* valid, const int* src,
    const float* resident, const float* extras, const float* cell_size,
    const float* radius, long long n, int* o1, int* o2, int* o3, int* o4,
    int* t1, int* t2, int* t3, int* t4, int* cell_idx, int* sub_idx,
    float* dist, float* pos_out, void* stream_handle) {
  const bool gather = src != nullptr, keys = cell_idx != nullptr;
  if (!pc_tile::valid_length(n) || (positions == nullptr) != gather ||
      (gather && (keys || pos_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  int* const out[4] = {o1, o2, o3, o4};
  int* const tmp[4] = {t1, t2, t3, t4};
  int* const* dst = pc_tile::tile_output(n, out, tmp);
  // one wave of 2 blocks an SM holds 264 tiles on the H100's 132 SMs:
  // up to 2^19 rows; above, the tiles take 4 an SM
  const bool wide = n <= (1LL << 19);
  auto kernel = gather ? (wide ? quantize_tile<true, false, 2>
                               : quantize_tile<true, false, 4>)
              : keys   ? (wide ? quantize_tile<false, true, 2>
                               : quantize_tile<false, true, 4>)
                       : (wide ? quantize_tile<false, false, 2>
                               : quantize_tile<false, false, 4>);
  kernel<<<pc_tile::tile_blocks(n), pc_tile::kThreads, 0, stream>>>(
      positions, valid, src, resident, extras, cell_size, radius, dst[0],
      dst[1], dst[2], dst[3], pc_tile::tile_rows(n), cell_idx, sub_idx, dist,
      pos_out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return pc_tile::merge_passes(n, out, tmp, stream);
}

// The division check (division_check_kernel) over ``count`` (cell size,
// radius) pairs on the device: ``bad`` and ``taken`` (5 * count, zeroed)
// get the mismatch and fast-path counts, ``first_bad`` (5 * count, all
// ones) the smallest mismatching numerator of each. Returns
// cudaGetLastError().
extern "C" int pc_division_check(const float* cell_size, const float* radius,
                                 int count, unsigned long long* bad,
                                 unsigned* first_bad,
                                 unsigned long long* taken,
                                 void* stream_handle) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  division_check_kernel<<<132 * 8, kThreads, 0,
                          static_cast<cudaStream_t>(stream_handle)>>>(
      cell_size, radius, count, bad, first_bad, taken);
  return static_cast<int>(cudaGetLastError());
}

// The significand sweep (division_sweep_kernel) of ``count`` divisors,
// first + j * stride (all below 2^23): ``bad`` (zeroed) gets the
// mismatching pairs, ``first_bad`` (all ones) the smallest. Returns
// cudaGetLastError().
extern "C" int pc_division_sweep(unsigned first, unsigned stride,
                                 unsigned count, unsigned long long* bad,
                                 unsigned long long* first_bad,
                                 void* stream_handle) {
  if (count < 1 || stride < 1 ||
      first + static_cast<unsigned long long>(count - 1) * stride >= (1u << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  division_sweep_kernel<<<count, kThreads, 0,
                          static_cast<cudaStream_t>(stream_handle)>>>(
      first, stride, bad, first_bad);
  return static_cast<int>(cudaGetLastError());
}
