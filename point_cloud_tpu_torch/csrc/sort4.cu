// sort4.cu — four-column lexicographic bitonic sort for Hopper (sm_90a).
//
// Replaces the Pallas tiled sort of point_cloud_tpu/ops/sort_pallas.py:
//   _call_sort_tiles (:217-228) with its chunk kernels
//     _make_sort_chunk_kernel (:145-170)     -> sort4_block
//   _call_merge_pairs / _merge_pair_kernel (:178-249)
//     (its distance-2^15 exchange)            -> sort4_global_step
//     (its in-tile substages)                 -> sort4_block_merge
//   _cross_exchange (:252-269, plain XLA)     -> sort4_global_step
//   _transpose_blocks / _to_tiles / _from_tiles (:272-309): no kernel;
//     the coalesced loads into shared memory and the stores back do the
//     relayout the TPU needed for its sublane-major tiles.
//
// Contract (pallas_sort4, :340-352): sort four equal-length int32 columns
// ascending, lexicographically; n is a power of two >= 1024. Column 4 is
// unique (the dedup arrival iota), so the order is total and the result
// equals np.lexsort((k4, k3, k2, k1)). The host wrapper checks shapes.
//
// Design: the bitonic network of ops/bitonic.py, regrouped for an SM.
// Stage s (1..log n) merges runs of 2^s rows; row i of stage s sorts
// ascending iff bit s of i is 0, taken from the GLOBAL row index, so a
// tile sorted by one block alternates direction with its neighbour and
// the next stage sees bitonic runs. A block holds T = 2048 rows (4 x 8 KB
// of shared memory) and runs every substage of distance < T in shared
// memory; each substage of distance >= T is one launch of a grid with
// one thread per pair.
//
// What bounds it: bytes. A global step reads 16 B and writes up to 16 B
// per row for four compares; a block pass moves the same 32 B per row
// for up to 11 substages. At n = 2^20: 1 block sort + 45 global steps
// + 9 block merges = 55 launches, ~1.8 GB of traffic (the 16 MB working
// set stays in the 50 MB L2). Speed (radix, merge paths, fewer passes)
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 11;  // 2048 rows per block

struct Row {
  int a, b, c, d;
};

__device__ __forceinline__ bool row_gt(const Row& x, const Row& y) {
  if (x.a != y.a) return x.a > y.a;
  if (x.b != y.b) return x.b > y.b;
  if (x.c != y.c) return x.c > y.c;
  return x.d > y.d;
}

// Index of the low row of compare-exchange pair p at distance 2^j.
__device__ __forceinline__ unsigned pair_lo(unsigned p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1u << j) - 1u));
}

// Substages j = j_hi..0 of stage s on a tile held in shared memory.
// `base` is the tile's first global row (the direction bit is global).
__device__ void tile_substages(int* s1, int* s2, int* s3, int* s4,
                               int tile_log, unsigned base, int s,
                               int j_hi) {
  const unsigned half = 1u << (tile_log - 1);
  for (int j = j_hi; j >= 0; --j) {
    for (unsigned p = threadIdx.x; p < half; p += blockDim.x) {
      const unsigned lo = pair_lo(p, j);
      const unsigned hi = lo + (1u << j);
      const bool up = (((base + lo) >> s) & 1u) == 0u;
      const Row x{s1[lo], s2[lo], s3[lo], s4[lo]};
      const Row y{s1[hi], s2[hi], s3[hi], s4[hi]};
      if (row_gt(x, y) == up) {
        s1[lo] = y.a; s2[lo] = y.b; s3[lo] = y.c; s4[lo] = y.d;
        s1[hi] = x.a; s2[hi] = x.b; s3[hi] = x.c; s4[hi] = x.d;
      }
    }
    __syncthreads();
  }
}

__device__ void load_tile(int* smem, const int* c1, const int* c2,
                          const int* c3, const int* c4, int tile,
                          unsigned base) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    smem[i] = c1[base + i];
    smem[tile + i] = c2[base + i];
    smem[2 * tile + i] = c3[base + i];
    smem[3 * tile + i] = c4[base + i];
  }
  __syncthreads();
}

__device__ void store_tile(const int* smem, int* c1, int* c2, int* c3,
                           int* c4, int tile, unsigned base) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    c1[base + i] = smem[i];
    c2[base + i] = smem[tile + i];
    c3[base + i] = smem[2 * tile + i];
    c4[base + i] = smem[3 * tile + i];
  }
}

// Stages 1..tile_log of every tile: in -> out.
__global__ void sort4_block(const int* __restrict__ k1,
                            const int* __restrict__ k2,
                            const int* __restrict__ k3,
                            const int* __restrict__ k4, int* o1, int* o2,
                            int* o3, int* o4, int tile_log) {
  extern __shared__ int smem[];
  const int tile = 1 << tile_log;
  const unsigned base = blockIdx.x * (unsigned)tile;
  load_tile(smem, k1, k2, k3, k4, tile, base);
  for (int s = 1; s <= tile_log; ++s)
    tile_substages(smem, smem + tile, smem + 2 * tile, smem + 3 * tile,
                   tile_log, base, s, s - 1);
  store_tile(smem, o1, o2, o3, o4, tile, base);
}

// Substages of distance < tile of a stage s > tile_log, in place.
__global__ void sort4_block_merge(int* o1, int* o2, int* o3, int* o4,
                                  int tile_log, int s) {
  extern __shared__ int smem[];
  const int tile = 1 << tile_log;
  const unsigned base = blockIdx.x * (unsigned)tile;
  load_tile(smem, o1, o2, o3, o4, tile, base);
  tile_substages(smem, smem + tile, smem + 2 * tile, smem + 3 * tile,
                 tile_log, base, s, tile_log - 1);
  store_tile(smem, o1, o2, o3, o4, tile, base);
}

// One substage at distance 2^j >= tile of stage s, in place.
__global__ void sort4_global_step(int* o1, int* o2, int* o3, int* o4,
                                  int j, int s, unsigned n_pairs) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const unsigned lo = pair_lo(p, j);
  const unsigned hi = lo + (1u << j);
  const bool up = ((lo >> s) & 1u) == 0u;
  const Row x{o1[lo], o2[lo], o3[lo], o4[lo]};
  const Row y{o1[hi], o2[hi], o3[hi], o4[hi]};
  if (row_gt(x, y) == up) {
    o1[lo] = y.a; o2[lo] = y.b; o3[lo] = y.c; o4[lo] = y.d;
    o1[hi] = x.a; o2[hi] = x.b; o3[hi] = x.c; o4[hi] = x.d;
  }
}

}  // namespace

// Sort (k1..k4) into (o1..o4) on `stream`. Returns cudaGetLastError()
// after the launches (0 = all launched); it does not synchronise.
extern "C" int pc_sort4(const int* k1, const int* k2, const int* k3,
                        const int* k4, int* o1, int* o2, int* o3, int* o4,
                        long long n, void* stream_handle) {
  if (n < 1024 || (n & (n - 1)) != 0 || n > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  int log_n = 0;
  while ((1LL << log_n) < n) ++log_n;
  const int tile_log = log_n < kTileLog ? log_n : kTileLog;
  const int tile = 1 << tile_log;
  const int threads = tile / 2;
  const size_t smem = 4 * (size_t)tile * sizeof(int);
  const unsigned blocks = (unsigned)(n >> tile_log);
  const unsigned n_pairs = (unsigned)(n / 2);
  const unsigned step_threads = 256;
  const unsigned step_blocks = (n_pairs + step_threads - 1) / step_threads;

  sort4_block<<<blocks, threads, smem, stream>>>(k1, k2, k3, k4, o1, o2, o3,
                                                 o4, tile_log);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int s = tile_log + 1; s <= log_n; ++s) {
    for (int j = s - 1; j >= tile_log; --j)
      sort4_global_step<<<step_blocks, step_threads, 0, stream>>>(
          o1, o2, o3, o4, j, s, n_pairs);
    sort4_block_merge<<<blocks, threads, smem, stream>>>(o1, o2, o3, o4,
                                                         tile_log, s);
  }
  return (int)cudaGetLastError();
}
