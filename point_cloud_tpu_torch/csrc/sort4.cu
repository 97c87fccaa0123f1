// sort4.cu — four-column lexicographic merge sort for Hopper (sm_90a).
//
// Replaces the Pallas tiled sort of point_cloud_tpu/ops/sort_pallas.py:
//   _call_sort_tiles (:217-228) with its chunk kernels
//     _make_sort_chunk_kernel (:145-170)        -> sort4_tile
//   _call_merge_pairs / _merge_pair_kernel (:178-249)
//     and _cross_exchange (:252-269, plain XLA) -> sort4_merge
//   _transpose_blocks / _to_tiles / _from_tiles (:272-309): no kernel;
//     the coalesced loads into shared memory and the stores back do the
//     relayout the TPU needed for its sublane-major tiles.
//
// Contract (pallas_sort4, :340-352): sort four equal-length int32 columns
// ascending, lexicographically as signed values; n is a power of two in
// [2^10, 2^30]. The result equals np.lexsort((k4, k3, k2, k1)) for any
// input: rows that compare equal are equal in all four columns, so their
// order cannot show. The host wrapper checks shapes.
//
// Design: a merge sort shaped for an SM.
// - A row is two u64 keys, (k1^2^31)<<32 | (k2^2^31) and the same for
//   (k3, k4). Flipping the sign bit keeps the signed order, so a compare
//   is two 64-bit compares instead of four 32-bit ones.
// - sort4_tile: a block of 256 threads sorts kRows = 2048 rows, 8 per
//   thread. Each thread sorts its 8 rows in registers (an unrolled
//   odd-even transposition network: no shared memory, no sync); then 8
//   rounds of merge-path merges through shared memory double the sorted
//   runs from 8 rows to 2048, two syncs a round (CUB's BlockMergeSort).
//   Its body is sort_tile in sort4_tile.cuh, a template on the row
//   loader: here it reads the four columns; quantize_hash.cu's
//   quantize_tile computes them from positions (B2 fused into the tile).
// - sort4_merge: one launch per pass merges the runs of width W = 2048,
//   4096, ..., n/2 in pairs. Each block writes 2048 consecutive output
//   rows. Two warps find the block's start and end in both runs by a
//   32-way search of the merge-path diagonal in global memory (a round
//   per 5 bits of W); the block stages the two slices in shared memory;
//   each thread finds its own diagonal there and merges 8 rows serially.
//   Ties take the left run, so no row is lost or doubled.
// - Shared memory holds rows at slot i + i/8: one 16-byte gap every 8
//   rows keeps both the per-thread (8 consecutive rows) and the per-warp
//   (32 consecutive rows) accesses free of bank conflicts.
// - Passes ping-pong between (o1..o4) and the caller's scratch (t1..t4);
//   the tile sort picks its output by the parity of the pass count, so
//   the last pass lands in (o1..o4). The kernels allocate nothing.
//   merge_passes runs the passes for pc_sort4 and pc_quantize_sort4.
//
// Launches: 1 + log2(n / 2048): 8 at 2^18, 10 at 2^20, each reading and
// writing 16 B per row (~336 MB in all at 2^20, held in the 50 MB L2 up
// to 2^21).
//
// What bounds it: latency, not bytes. At 2^18 (128 blocks, one per SM)
// the tile sort takes ~25 us for 4 MB, a chain of ~120 dependent
// shared-memory steps (8 binary searches and 8 serial merges) with 8
// warps an SM to hide them; at 2^20 (4 blocks an SM) it sorts 4x the rows
// in ~2x the time. A merge pass at 2^18 takes ~7 us for 8 MB of L2
// traffic: 4 rounds of dependent global loads in the split search, then
// the staging load, the merge and the store (H100, PERF.md, PR 2).

#include <cuda_runtime.h>

#include "sort4_tile.cuh"

namespace pc_tile {
namespace {

__device__ __forceinline__ Key load_key(const int* c1, const int* c2,
                                        const int* c3, const int* c4,
                                        long long r) {
  return make_key(__ldg(c1 + r), __ldg(c2 + r), __ldg(c3 + r), __ldg(c4 + r));
}

// How many of the first d rows of merge(A, B) come from A, where A is rows
// [pair, pair + w) and B rows [pair + w, pair + 2w) of the columns; run by
// one whole warp. Each round probes 32 points of the diagonal: the lanes
// where A[p] <= B[d-1-p] form a prefix, and the answer lies between the
// last of them and the next probe.
__device__ long long warp_split(const int* c1, const int* c2, const int* c3,
                                const int* c4, long long pair, long long w,
                                long long d) {
  const long long lane = threadIdx.x & 31;
  long long lo = d > w ? d - w : 0;
  long long hi = d < w ? d : w;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + (lane + 1) * step - 1;
    bool a_gt_b = true;  // beyond hi: the answer is at most hi
    if (p < hi)
      a_gt_b = key_less(load_key(c1, c2, c3, c4, pair + w + d - 1 - p),
                        load_key(c1, c2, c3, c4, pair + p));
    const long long c = __popc(__ballot_sync(0xffffffffu, !a_gt_b));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  return lo;
}

// sort_tile's loader: a thread's keys from the four columns.
struct ColumnLoader {
  const int* c1;
  const int* c2;
  const int* c3;
  const int* c4;
  __device__ __forceinline__ void fill(Key (&k)[kItems], long long base,
                                       int rows) const {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + threadIdx.x;
      k[j] = i < rows ? load_key(c1, c2, c3, c4, base + i)
                      : make_ulonglong2(~0ull, ~0ull);
    }
  }
};

// Sorts each run of kRows rows: (k1..k4) -> (o1..o4) (sort_tile).
__global__ void __launch_bounds__(kThreads)
    sort4_tile(const int* __restrict__ k1, const int* __restrict__ k2,
               const int* __restrict__ k3, const int* __restrict__ k4,
               int* __restrict__ o1, int* __restrict__ o2,
               int* __restrict__ o3, int* __restrict__ o4, int rows) {
  __shared__ Key s[kShared];  // 36 KB
  sort_tile(ColumnLoader{k1, k2, k3, k4}, s, o1, o2, o3, o4, rows);
}

// One merge pass: the sorted runs of width w in (i1..i4), merged in pairs,
// to (o1..o4). Block b writes output rows [b, b + 1) * kRows.
__global__ void __launch_bounds__(kThreads)
    sort4_merge(const int* __restrict__ i1, const int* __restrict__ i2,
                const int* __restrict__ i3, const int* __restrict__ i4,
                int* __restrict__ o1, int* __restrict__ o2,
                int* __restrict__ o3, int* __restrict__ o4, long long w) {
  __shared__ Key s[kRows + kRows / 8];  // 36 KB
  __shared__ long long split[2];
  const long long out0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long pair = out0 & ~(2 * w - 1);
  const long long d0 = out0 - pair;
  if (threadIdx.x < 64) {
    const int which = threadIdx.x >> 5;
    const long long from_a =
        warp_split(i1, i2, i3, i4, pair, w, d0 + which * kRows);
    if ((threadIdx.x & 31) == 0) split[which] = from_a;
  }
  __syncthreads();
  const int a_len = static_cast<int>(split[1] - split[0]);
  const long long a_src = pair + split[0];
  const long long b_src = pair + w + d0 - split[0];
  Key k[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    k[j] = load_key(i1, i2, i3, i4, i < a_len ? a_src + i : b_src + (i - a_len));
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    s[slot(j * kThreads + threadIdx.x)] = k[j];
  __syncthreads();
  const int diag = threadIdx.x * kItems;
  const int from_a = merge_path(s, 0, a_len, a_len, kRows - a_len, diag);
  serial_merge(s, from_a, a_len, a_len + diag - from_a, kRows, k);
  __syncthreads();
  store_blocked(s, k);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    store_key(o1, o2, o3, o4, out0 + i, s[slot(i)]);
  }
}

}  // namespace

int merge_passes(long long n, int* const* out, int* const* tmp,
                 cudaStream_t stream) {
  int* const* dst = tile_output(n, out, tmp);
  int* const* src = dst == out ? tmp : out;
  for (long long w = kRows; w < n; w *= 2) {
    int* const* t = src;
    src = dst;
    dst = t;
    sort4_merge<<<static_cast<unsigned>(n / kRows), kThreads, 0, stream>>>(
        src[0], src[1], src[2], src[3], dst[0], dst[1], dst[2], dst[3], w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace pc_tile

// Sort (k1..k4) into (o1..o4) on `stream`, with (t1..t4) as scratch of the
// same length. Returns cudaGetLastError() after each launch (0 = all
// launched); it does not synchronise.
extern "C" int pc_sort4(const int* k1, const int* k2, const int* k3,
                        const int* k4, int* o1, int* o2, int* o3, int* o4,
                        int* t1, int* t2, int* t3, int* t4, long long n,
                        void* stream_handle) {
  using namespace pc_tile;
  if (!valid_length(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  int* const out[4] = {o1, o2, o3, o4};
  int* const tmp[4] = {t1, t2, t3, t4};
  int* const* dst = tile_output(n, out, tmp);
  sort4_tile<<<tile_blocks(n), kThreads, 0, stream>>>(
      k1, k2, k3, k4, dst[0], dst[1], dst[2], dst[3], tile_rows(n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_passes(n, out, tmp, stream);
}
