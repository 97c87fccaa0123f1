// lod_select.cu — the renderer's LOD walk (K6), for Hopper (sm_90a).
//
// Replaces point_cloud_tpu/render/kernel.py lod_select (_lod_walk_body,
// :172-196) together with the loaded-cells probe it calls once a level,
// hash_member (:126-136). The reference computes both in XLA (no Pallas
// kernel); eagerly in PyTorch they are ~60 small launches a finer
// hierarchy (a divide and floor, a cat, the row hash emulated in masked
// int64, the bucket gather, compares and wheres), so a bucket of a
// 12-hierarchy store queues ~650 launches for a few hundred KB of reads.
//
// One thread a row, one launch a bucket. A thread reads its row's position
// and hierarchy, clamps own to last, then walks h = max(own + 1, 1) .. last:
//   (x, y, z) = int32(floor(p / cell_sizes[h])), the divide IEEE
//   round-to-nearest (__fdiv_rn, as torch's CUDA division of two device
//   tensors) and the cast truncating and saturating, NaN to 0
//   (__float2int_rz, as torch's CUDA .to(torch.int32));
//   the row hash of (h, x, y, z) in native uint32, the constants and shifts
//   of render/kernel.py _hash_rows_np;
//   the row's bucket, hash & (NB - 1): BUCKET_ROWS = 4 rows of 16 B, one
//   64 B line read as four int4 loads, every row compared in full;
//   a hit moves the result to h, the first miss ends the walk.
// The early exit is the eager walk's own semantics: its `alive` never turns
// true again once false, and its result moves only while alive, so the
// output is bit-identical to the plain version (render/kernel.py
// lod_select_reference), padding rows included. cell_sizes and the table
// are read from device memory: no host sync.
//
// What bounds it: at 0.34 M rows (the orbit's frame) a walk reads 16 B and
// writes 4 B a row, plus probes of a table of a few KB to MB that stays in
// the 50 MB L2: ~7 MB, ~2 us at 3.35 TB/s. In practice the launch and the
// chain of probes bound a bucket: each probe's load waits on the last
// probe's compare, so a row's walk is a few dependent memory latencies
// (8-28 us a bucket of 2^12-2^18 rows over twelve levels on an H100, from
// a flushed L2). The design's point is one launch in place of hundreds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBucketRows = 4;  // render/kernel.py BUCKET_ROWS

// render/kernel.py _hash_rows_np on one (h, x, y, z) row, in uint32
__device__ __forceinline__ unsigned hash_row(int h, int x, int y, int z) {
  const int row[4] = {h, x, y, z};
  unsigned out = 0x1000193u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out = (out ^ (static_cast<unsigned>(row[i]) * 0x9E3779B1u)) * 0x85EBCA77u;
    out ^= out >> 15;
  }
  out *= 0xC2B2AE3Du;
  return out ^ (out >> 13);
}

__device__ __forceinline__ bool same_row(int4 a, int h, int x, int y, int z) {
  return a.x == h && a.y == x && a.z == y && a.w == z;
}

__global__ void __launch_bounds__(kThreads) lod_select_kernel(
    const float* __restrict__ positions, const int* __restrict__ hierarchy,
    const float* __restrict__ cell_sizes, const int4* __restrict__ table,
    unsigned bucket_mask, int last, int* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = positions[3 * i];
  const float py = positions[3 * i + 1];
  const float pz = positions[3 * i + 2];
  const int own = min(hierarchy[i], last);
  int result = own;
  for (int h = max(own + 1, 1); h <= last; ++h) {
    const float size = __ldg(cell_sizes + h);
    const int x = __float2int_rz(floorf(__fdiv_rn(px, size)));
    const int y = __float2int_rz(floorf(__fdiv_rn(py, size)));
    const int z = __float2int_rz(floorf(__fdiv_rn(pz, size)));
    const int4* bucket =
        table + static_cast<size_t>(hash_row(h, x, y, z) & bucket_mask) *
                    kBucketRows;
    bool found = false;
#pragma unroll
    for (int k = 0; k < kBucketRows; ++k)
      found |= same_row(__ldg(bucket + k), h, x, y, z);
    if (!found) break;
    result = h;
  }
  out[i] = result;
}

}  // namespace

// positions (n, 3) f32, hierarchy (n,) i32, cell_sizes (>= last + 1) f32,
// table (num_buckets, 16) i32 with num_buckets a power of two, 16-byte
// aligned; out (n,) i32. Returns the launch's cudaError_t.
extern "C" int pc_lod_select(const float* positions, const int* hierarchy,
                             const float* cell_sizes, const int* table,
                             long long num_buckets, int last, int* out,
                             long long n, void* stream) {
  if (num_buckets < 1 || (num_buckets & (num_buckets - 1)) != 0 ||
      num_buckets > (1LL << 32))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  lod_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      positions, hierarchy, cell_sizes, reinterpret_cast<const int4*>(table),
      static_cast<unsigned>(num_buckets - 1), last, out, n);
  return static_cast<int>(cudaGetLastError());
}
