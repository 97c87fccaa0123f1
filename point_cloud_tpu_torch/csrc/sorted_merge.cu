// sorted_merge.cu — the framebuffer merge of the sorted raster (K4), for
// Hopper (sm_90a).
//
// Replaces the tail of the reference's sorted_raster_merge,
// point_cloud_tpu/render/splat.py:537-564 — the first row of each pixel
// run (:537-539), compact_winner_rows (:438-504, with the in-chunk
// bitonic partition _partition_chunks, :391-436) and the two scatter-mins
// of depth and id (:551-563) — for fragment columns that sort4 has
// ordered by (pixel, depth bits, id, arrival). The reference runs them in
// XLA (no Pallas kernel). Its winner compaction exists to narrow the TPU's
// scatters, whose cost is per row processed; here a row that does not win
// costs one 4-byte load, so there is nothing to compact.
//
// Row i wins if pix[i] != _NO_ID, pix[i] lies on the plane and i starts
// its pixel's run (i == 0 or pix[i - 1] != pix[i]): the run's first row is
// its smallest (depth bits, id). A winner merges the word
// depth_bits << 32 | id (both as 32 unsigned bits) into the framebuffer by
// a 64-bit unsigned minimum: depths are in [0, 1], where the bits order
// like the values, so the minimum word is the nearest fragment and, among
// equal depths, the smallest id — the reference's two scatter-mins in one
// comparison. A pixel has at most one winner in a merge, so no other
// thread of the launch touches its word and the minimum needs no atomic.
//
// One thread a row, a grid-stride loop with 64-bit indices. What bounds
// it: bytes — 4 a row for the pixel column (its neighbour's comes from the
// same or the previous cache line), 8 a winner for its depth and id, and
// 16 a winner for the framebuffer word read and written
// (chip_smoke.py merge_bound_ms).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNoId = 0x7fffffff;

__global__ void __launch_bounds__(kThreads) sorted_merge_kernel(
    unsigned long long* __restrict__ fb, long long n_pix,
    const int* __restrict__ pix, const int* __restrict__ bits,
    const int* __restrict__ ids, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const int p = pix[i];
    if (p == kNoId || p < 0 || p >= n_pix) continue;
    if (i > 0 && pix[i - 1] == p) continue;
    const unsigned long long word =
        (static_cast<unsigned long long>(static_cast<unsigned>(bits[i]))
         << 32) |
        static_cast<unsigned>(ids[i]);
    if (word < fb[p]) fb[p] = word;
  }
}

}  // namespace

// Merges the sorted columns (pix, bits, ids) of length ``n`` into the
// ``n_pix``-word framebuffer ``fb``. Returns the cudaError_t of the
// launch.
extern "C" int pc_sorted_merge(unsigned long long* fb, long long n_pix,
                               const int* pix, const int* bits,
                               const int* ids, long long n, void* stream) {
  if (n < 1 || n_pix < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  sorted_merge_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(fb, n_pix, pix,
                                                             bits, ids, n);
  return static_cast<int>(cudaGetLastError());
}
