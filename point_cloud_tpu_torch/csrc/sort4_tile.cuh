// sort4_tile.cuh — sort4's tile sort for Hopper (sm_90a), as a template on
// where its rows come from.
//
// The body of sort4.cu's tile sort (see the design note there): a block
// of kThreads threads sorts kRows rows, kItems a thread, first in registers
// (an odd-even transposition network), then in 8 rounds of merge-path
// merges through shared memory. Only the first step differs between its
// two kernels. A Loader fills a thread's kItems keys, ``load.fill(k,
// base, rows)``: row j is the tile's row j * kThreads + threadIdx.x, the
// array's row base + that, and rows at or past ``rows`` are all ones:
// - sort4.cu's sort4_tile reads four int32 columns;
// - quantize_hash.cu's quantize_tile computes the row's key from its
//   position (B2's arithmetic, hex_keys.cuh), so the four sort columns
//   exist only in registers and shared memory until the tile is sorted.
// Either leaves sorted runs of kRows rows for sort4_merge's passes,
// ``merge_passes``, defined in sort4.cu beside the kernel.

#pragma once

#include <cuda_runtime.h>

namespace pc_tile {

// One block shape for both kernels, chosen by measurement (PERF.md)
constexpr int kThreads = 256;
constexpr int kItems = 8;  // rows per thread
constexpr int kRows = kThreads * kItems;
constexpr int kShared = kRows + kRows / 8;  // Keys, one gap every 8 rows

using Key = ulonglong2;  // x = (k1, k2), y = (k3, k4), sign bits flipped

__device__ __forceinline__ Key make_key(int a, int b, int c, int d) {
  const unsigned s = 0x80000000u;
  return make_ulonglong2(
      (static_cast<unsigned long long>(static_cast<unsigned>(a) ^ s) << 32) |
          (static_cast<unsigned>(b) ^ s),
      (static_cast<unsigned long long>(static_cast<unsigned>(c) ^ s) << 32) |
          (static_cast<unsigned>(d) ^ s));
}

__device__ __forceinline__ void store_key(int* o1, int* o2, int* o3, int* o4,
                                          long long r, const Key& k) {
  const unsigned s = 0x80000000u;
  o1[r] = static_cast<int>(static_cast<unsigned>(k.x >> 32) ^ s);
  o2[r] = static_cast<int>(static_cast<unsigned>(k.x) ^ s);
  o3[r] = static_cast<int>(static_cast<unsigned>(k.y >> 32) ^ s);
  o4[r] = static_cast<int>(static_cast<unsigned>(k.y) ^ s);
}

__device__ __forceinline__ bool key_less(const Key& p, const Key& q) {
  return p.x < q.x || (p.x == q.x && p.y < q.y);
}

__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }

__device__ __forceinline__ void sort_registers(Key (&k)[kItems]) {
#pragma unroll
  for (int round = 0; round < kItems; ++round) {
#pragma unroll
    for (int i = round & 1; i + 1 < kItems; i += 2) {
      if (key_less(k[i + 1], k[i])) {
        const Key t = k[i];
        k[i] = k[i + 1];
        k[i + 1] = t;
      }
    }
  }
}

// Shared rows [a, a + a_len) and [b, b + b_len) are two sorted runs: how
// many of the first `diag` rows of their merge come from the first.
__device__ __forceinline__ int merge_path(const Key* s, int a, int a_len,
                                          int b, int b_len, int diag) {
  int lo = max(0, diag - b_len);
  int hi = min(diag, a_len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(s[slot(b + diag - 1 - mid)], s[slot(a + mid)]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The next kItems rows of the merge of shared runs [a, a_end) and
// [b, b_end); ties take the first run. Reads stay inside the kRows rows.
__device__ __forceinline__ void serial_merge(const Key* s, int a, int a_end,
                                             int b, int b_end,
                                             Key (&out)[kItems]) {
  constexpr int last = kRows - 1;
  Key ka = s[slot(min(a, last))];
  Key kb = s[slot(min(b, last))];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_b = b < b_end && (a >= a_end || key_less(kb, ka));
    out[j] = take_b ? kb : ka;
    if (take_b)
      kb = s[slot(min(++b, last))];
    else
      ka = s[slot(min(++a, last))];
  }
}

__device__ __forceinline__ void store_blocked(Key* s, const Key (&k)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) s[slot(threadIdx.x * kItems + j)] = k[j];
}

// Sorts the block's run of kRows rows, from ``load`` into (o1..o4). With n
// below kRows one block sorts ``rows`` = n rows; the rest of its tile
// holds all-ones keys, which sort last and are not stored.
template <class Loader>
__device__ __forceinline__ void sort_tile(const Loader& load,
                                          Key (&s)[kShared], int* o1,
                                          int* o2, int* o3, int* o4,
                                          int rows) {
  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  Key k[kItems];
  load.fill(k, base, rows);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    s[slot(j * kThreads + threadIdx.x)] = k[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    k[j] = s[slot(threadIdx.x * kItems + j)];
  sort_registers(k);
  // each round merges pairs of sorted runs held by width / 2 threads each
  for (int width = 2; width <= kThreads; width *= 2) {
    __syncthreads();
    store_blocked(s, k);
    __syncthreads();
    const int half = kItems * width / 2;
    const int a = (threadIdx.x & ~(width - 1)) * kItems;
    const int diag = (threadIdx.x & (width - 1)) * kItems;
    const int from_a = merge_path(s, a, half, a + half, half, diag);
    serial_merge(s, a + from_a, a + half, a + half + diag - from_a,
                 a + 2 * half, k);
  }
  __syncthreads();
  store_blocked(s, k);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < rows) store_key(o1, o2, o3, o4, base + i, s[slot(i)]);
  }
}

// --- host side: the launch geometry shared by pc_sort4 and
// pc_quantize_sort4

// n is a length the kernels take: a power of two in [2^10, 2^30]
inline bool valid_length(long long n) {
  return n >= 1024 && (n & (n - 1)) == 0 && n <= (1LL << 30);
}

inline int tile_rows(long long n) {
  return n < kRows ? static_cast<int>(n) : kRows;
}

inline unsigned tile_blocks(long long n) {
  return static_cast<unsigned>(n < kRows ? 1 : n / kRows);
}

inline int merge_count(long long n) {
  int passes = 0;
  for (long long w = kRows; w < n; w *= 2) ++passes;
  return passes;
}

// Where the tile sort writes: the scratch (t1..t4) when an odd number of
// merge passes follows, so that the last pass lands in (o1..o4).
inline int* const* tile_output(long long n, int* const* out,
                               int* const* tmp) {
  return merge_count(n) % 2 ? tmp : out;
}

// The merge passes after a tile sort into tile_output(n, out, tmp): one
// sort4_merge launch for each run width 2048, ..., n / 2, on ``stream``.
// Returns cudaGetLastError() after each launch (0 = all launched).
int merge_passes(long long n, int* const* out, int* const* tmp,
                 cudaStream_t stream);

}  // namespace pc_tile
