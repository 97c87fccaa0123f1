// class_rank.cu — K5, the frame's stable class ranking, for Hopper (sm_90a).
//
// Replaces the reference's compact_classes,
// point_cloud_tpu/render/splat.py:96-139 (C exclusive class masks ranked
// into one (2N,) permutation with device-side counts and offsets), the
// index scatter of its compact_rows (:62-94: the kept rows, in row order,
// in ``out_size`` slots, the rest dropped) and the budget arm's spill ranks
// (:791-835: a row's rank in its rung). The reference runs them in XLA (no
// Pallas kernel); the port's plain version is one cumsum over a class-major
// (C+1) x N one-hot, a gather and a scatter, O((C+1) N) work.
//
// Input: ``rung`` (N,) — i32 classes in [0, C), any other value meaning no
// class, or a bool mask (C = 1: true is class 0). Output, on the device and
// with no host sync:
//   perm    (out_size,) i32: class c's rows, in row order, at
//           [offsets[c], offsets[c] + counts[c]); a row whose slot is
//           out_size or more is dropped; the slots past the last kept row
//           hold 0 (the plain version's zero fill);
//   counts, offsets (C,) i32: rows of each class (past out_size too) and
//           the exclusive sum of counts;
//   dest    (N,) i32, optional: each row's slot, out_size for no class.
// compact_classes passes out_size = 2N (nothing dropped), compact_perm C = 1
// and its cap.
//
// Three launches, a tile of kTileRows rows a block (kWarps warps, each a
// run of kItems steps of 32 consecutive rows):
// 1. class_rank_hist: each warp counts its run's rows by class (per step,
//    __match_any_sync groups the lanes of one class and the group's lowest
//    lane adds its popcount to the warp's counter), and the tile writes its
//    per-class total into the class-major (C, tiles) histogram.
// 2. class_rank_scan: a warp a class turns its histogram row into the
//    exclusive prefix over tiles, and writes the row total.
// 3. class_rank_scatter: each tile recounts its warps, takes the classes'
//    offsets (a block scan of the row totals), and gives each (warp, class)
//    its base: the class offset, the tiles before and the warps before in
//    the tile. Then each warp ranks its steps in order — a lane's rank is
//    the popcount of its group's lower lanes — and writes perm and dest;
//    the group's lowest lane advances the warp's base. All blocks then
//    zero the slots past the last kept row.
// Row order is kept at every level (lanes, steps, warps, tiles, classes),
// so the ranking is stable, and the result does not depend on the order
// blocks run in: no atomics, no chained scan, no scratch to zero.
//
// The warp counters, kWarps x C ints a block, live in shared memory up to
// kSharedClasses classes (32 KB) and in global scratch, a block's own
// slice, past it: no class count is refused. The histogram is C x tiles
// ints, about C / 4096 of the rows.
//
// What bounds it: bytes. The rung column read once (4 B a row; 1 for a
// mask), every perm slot written once (4 B each: 8 a row for the 2N
// ranking), 4 B a row of dest when asked: 12 B a row for compact_classes,
// 3.8 us at 2^20 rows at 3.35 TB/s, whatever C is. Kernel 3 reads the
// rung column again (from L2: a 2^20-row bucket's 4 MB stays there), and
// the histogram and the counters scale with C x tiles, which the bound
// does not count. Each launch is short, and the three pay their fixed
// latencies as much as their bytes: on an H100 SXM at 700 W
// (chip_smoke.py, the orbit frame's largest bucket, 2^20 rows, 12
// classes) 12.5 us of device time, 3.8 in the histogram, 2.1 in the scan
// of a few KB and 6.7 in the scatter, a third of the rate the bound
// assumes; 14.8 us at 129 classes. Folding the histogram into K1, which
// writes the rung column, and the scan into the scatter would take two
// launches away.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // steps of 32 rows a warp
constexpr int kTileRows = kThreads * kItems;
constexpr int kSharedClasses = 1024;  // 32 KB of counters a block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int class_of(int v, int n_classes) {
  return v >= 0 && v < n_classes ? v : n_classes;
}

__device__ __forceinline__ int class_of(unsigned char v, int n_classes) {
  return v ? 0 : n_classes;
}

// The classes of a warp's run (n_classes where the row has none or lies
// past n): step s, lane l holds row first + 32 s + l.
template <typename T>
__device__ __forceinline__ void load_classes(const T* __restrict__ rung,
                                             long long n, int n_classes,
                                             long long first, int lane,
                                             int* cls) {
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const long long row = first + 32 * s + lane;
    cls[s] = row < n ? class_of(__ldg(rung + row), n_classes) : n_classes;
  }
}

// Adds the warp's rows of each class to its counters ``cw`` (C ints).
__device__ __forceinline__ void count_warp(volatile int* cw, const int* cls,
                                           int n_classes, int lane) {
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int c = cls[s];
    const unsigned peers = __match_any_sync(kFull, c);
    if (c < n_classes && lane == __ffs(peers) - 1) cw[c] += __popc(peers);
    __syncwarp();
  }
}

// The block's counters, kWarps x C: shared memory, or the block's slice of
// global scratch; zeroed.
template <bool kGlobal>
__device__ __forceinline__ volatile int* block_counters(int* scratch,
                                                        int n_classes) {
  extern __shared__ int smem[];
  int* cnt = kGlobal ? scratch + static_cast<long long>(blockIdx.x) *
                                     kWarps * n_classes
                     : smem;
  for (int i = threadIdx.x; i < kWarps * n_classes; i += kThreads) cnt[i] = 0;
  __syncthreads();
  return cnt;
}

// Exclusive scan of ``v`` over the block; ``total`` gets the block's sum.
// ``sums`` holds kWarps + 1 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) sums[lane] = wi - w;
    if (lane == kWarps - 1) sums[kWarps] = wi;
  }
  __syncthreads();
  total = sums[kWarps];
  const int out = sums[warp] + x - v;
  __syncthreads();  // ``sums`` is free for the next call
  return out;
}

template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads) class_rank_hist(
    const T* __restrict__ rung, long long n, int n_classes, int tiles,
    int* __restrict__ hist, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cls[kItems];
  load_classes(rung, n, n_classes,
               static_cast<long long>(blockIdx.x) * kTileRows +
                   warp * (32 * kItems),
               lane, cls);
  volatile int* cnt = block_counters<kGlobal>(scratch, n_classes);
  count_warp(cnt + warp * n_classes, cls, n_classes, lane);
  __syncthreads();
  for (int c = threadIdx.x; c < n_classes; c += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += cnt[w * n_classes + c];
    hist[static_cast<long long>(c) * tiles + blockIdx.x] = sum;
  }
}

// A warp a class: the class's histogram row becomes its exclusive prefix
// over tiles (a lane a contiguous part of the row), and tot[c] its total.
__global__ void __launch_bounds__(kThreads) class_rank_scan(
    int* __restrict__ hist, int tiles, int n_classes, int* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_classes) return;
  int* row = hist + static_cast<long long>(c) * tiles;
  const int per = (tiles + 31) / 32;
  const int lo = lane * per < tiles ? lane * per : tiles;
  const int hi = lo + per < tiles ? lo + per : tiles;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += row[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  int run = x - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = row[i];
    row[i] = run;
    run += v;
  }
  if (lane == 31) tot[c] = x;
}

template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads) class_rank_scatter(
    const T* __restrict__ rung, long long n, int n_classes, int tiles,
    const int* __restrict__ hist, const int* __restrict__ tot, int* scratch,
    int* __restrict__ perm, int out_size, int* __restrict__ counts,
    int* __restrict__ offsets, int* __restrict__ dest) {
  __shared__ int sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kTileRows +
                          warp * (32 * kItems);
  int cls[kItems];
  load_classes(rung, n, n_classes, first, lane, cls);
  volatile int* cnt = block_counters<kGlobal>(scratch, n_classes);
  count_warp(cnt + warp * n_classes, cls, n_classes, lane);
  __syncthreads();
  // each (warp, class)'s base: the class's offset, the rows of the class in
  // the tiles before, and in the warps before in this tile
  int carry = 0;
  for (int c0 = 0; c0 < n_classes; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const int v = c < n_classes ? tot[c] : 0;
    int chunk = 0;
    const int off = carry + block_exclusive_scan(v, sums, chunk);
    if (c < n_classes) {
      if (blockIdx.x == 0) {
        counts[c] = v;
        offsets[c] = off;
      }
      int run = off + hist[static_cast<long long>(c) * tiles + blockIdx.x];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int rows = cnt[w * n_classes + c];
        cnt[w * n_classes + c] = run;
        run += rows;
      }
    }
    carry += chunk;
  }
  __syncthreads();
  volatile int* cw = cnt + warp * n_classes;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int c = cls[s];
    const long long row = first + 32 * s + lane;
    const unsigned peers = __match_any_sync(kFull, c);
    int slot = out_size;
    if (c < n_classes) {
      slot = cw[c] + __popc(peers & lower);
      if (slot < out_size) perm[slot] = static_cast<int>(row);
    }
    if (dest != nullptr && row < n) dest[row] = slot;
    __syncwarp();
    if (c < n_classes && lane == __ffs(peers) - 1)
      cw[c] = slot + __popc(peers);
    __syncwarp();
  }
  // the slots past the last kept row (carry: every class's rows)
  const long long kept = carry < out_size ? carry : out_size;
  for (long long i = kept + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < out_size; i += static_cast<long long>(gridDim.x) * kThreads)
    perm[i] = 0;
}

long long tiles_of(long long n) { return (n + kTileRows - 1) / kTileRows; }

bool global_counters(int n_classes) { return n_classes > kSharedClasses; }

template <typename T, bool kGlobal>
cudaError_t launch(const T* rung, long long n, int n_classes, int* perm,
                   int out_size, int* counts, int* offsets, int* dest,
                   int* hist, int* tot, int* counters, cudaStream_t stream) {
  const int tiles = static_cast<int>(tiles_of(n));
  const size_t smem = kGlobal ? 0 : sizeof(int) * kWarps * n_classes;
  class_rank_hist<T, kGlobal><<<tiles, kThreads, smem, stream>>>(
      rung, n, n_classes, tiles, hist, counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  class_rank_scan<<<(n_classes + kWarps - 1) / kWarps, kThreads, 0,
                    stream>>>(hist, tiles, n_classes, tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  class_rank_scatter<T, kGlobal><<<tiles, kThreads, smem, stream>>>(
      rung, n, n_classes, tiles, hist, tot, counters, perm, out_size, counts,
      offsets, dest);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const T* rung, long long n, int n_classes, int* perm,
                       int out_size, int* counts, int* offsets, int* dest,
                       int* hist, int* tot, int* counters,
                       cudaStream_t stream) {
  return global_counters(n_classes)
             ? launch<T, true>(rung, n, n_classes, perm, out_size, counts,
                               offsets, dest, hist, tot, counters, stream)
             : launch<T, false>(rung, n, n_classes, perm, out_size, counts,
                                offsets, dest, hist, tot, counters, stream);
}

}  // namespace

// Ints of scratch a call of ``n`` rows and ``n_classes`` classes needs: the
// (C, tiles) histogram, the C row totals and, past kSharedClasses, the
// blocks' counters. -1 where the call is out of range.
extern "C" long long pc_class_rank_scratch(long long n, int n_classes) {
  if (n < 1 || n > (1LL << 30) || n_classes < 1) return -1;
  const long long tiles = tiles_of(n);
  const long long c = n_classes;
  return c * tiles + c +
         (global_counters(n_classes) ? tiles * kWarps * c : 0);
}

// K5 on ``n`` rows of ``rung`` (i32, or one byte a row where ``is_mask``:
// then n_classes must be 1), into ``perm`` (out_size slots), ``counts`` and
// ``offsets`` (n_classes each) and, unless null, ``dest`` (n). ``scratch``
// holds ``scratch_len`` ints, at least pc_class_rank_scratch(n, n_classes).
// Returns the cudaError_t of the launches.
extern "C" int pc_class_rank(const void* rung, int is_mask, long long n,
                             int n_classes, int* perm, long long out_size,
                             int* counts, int* offsets, int* dest,
                             int* scratch, long long scratch_len,
                             void* stream_handle) {
  const long long need = pc_class_rank_scratch(n, n_classes);
  if (need < 0 || scratch_len < need || out_size < 0 || out_size > INT_MAX ||
      (is_mask && n_classes != 1) || (out_size > 0 && perm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = tiles_of(n);
  int* hist = scratch;
  int* tot = hist + static_cast<long long>(n_classes) * tiles;
  int* counters = tot + n_classes;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int out = static_cast<int>(out_size);
  const cudaError_t err =
      is_mask ? launch_any(static_cast<const unsigned char*>(rung), n,
                           n_classes, perm, out, counts, offsets, dest, hist,
                           tot, counters, stream)
              : launch_any(static_cast<const int*>(rung), n, n_classes, perm,
                           out, counts, offsets, dest, hist, tot, counters,
                           stream);
  return static_cast<int>(err);
}
