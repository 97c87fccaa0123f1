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
// costs 4 bytes of the pixel column, so there is nothing to compact.
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
// Precondition: the columns are sort4's output, ascending by pixel. Then
// negative pixels come first, pixels past the plane just before the end,
// and every _NO_ID row (INT32_MAX: K3's padding, empty class slots and
// rejected fragments) lies in one tail at the end, where no row can win.
//
// What bounds it: bytes from HBM — 4 a row of the pixel column up to the
// row that starts the _NO_ID tail, 8 a winner for its depth and id and 16
// for its framebuffer word read and written (chip_smoke.py
// merge_bound_ms). The design keeps enough of those bytes in flight and
// reads no more of the tail than that:
//
// 1. A warp walks chunks of 32 x kUnroll int4 vectors of the pixel column
//    (16 bytes a lane a load, read-only and not kept in L1), chunks in
//    ascending address order, strided over a persistent grid sized for
//    the device on every call and capped at about kInFlightBytes of loads
//    a SM. The next chunk's loads are issued before the current chunk's
//    winners load their depth, id and plane word, and the lanes of a
//    warp load their winners in the same round (a lane one winner a
//    round), so a chunk's winners cost it about one round trip, with the
//    next chunk's loads in flight.
// 2. A row's run start comes from registers: row j of a vector compares
//    with row j - 1 of it, the first row with the previous lane's last
//    row (__shfl_up_sync), lane 0's with the previous vector's or, for the
//    chunk's first vector, one scalar load of the row before the chunk.
// 3. Once a chunk's last row is _NO_ID, every later chunk of the warp's
//    stride is tail, and the warp leaves: the grid reads at most one chunk
//    of tail a warp (the bytes in flight), with no host sync and no count
//    from K3.
//
// A head up to the column's first 16-byte boundary and a ragged end of
// fewer than four rows run as scalar rows, so any n >= 1 and any 4-byte
// aligned column (a view at an offset) works.
//
// kUnroll and kInFlightBytes were chosen by tools/kernel_ab.py merge on an
// H100 (PERF.md): 4 vectors a lane and 64 KB a SM (four blocks of
// the 62-register kernel) were the fastest on a dense list and within 2%
// of 2 vectors on a list shaped like the sorted arm's largest bucket; 32
// KB was up to 6% slower, and a cp.async.bulk ring of 16 KB tiles 3-9%
// slower. The pixel column alone streams at about 83% of the HBM rate;
// each winner costs about as much as 200 more bytes at that rate, since
// its depth and id are two scattered DRAM reads where the bound counts 8
// bytes, and that keeps a list with many winners far from its bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // int4 loads in flight a lane
constexpr int kChunkVecs = 32 * kUnroll;
constexpr int kInFlightBytes = 64 << 10;  // pixel-column loads a SM
constexpr int kNoId = 0x7fffffff;

__device__ __forceinline__ int4 load_streaming(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Row i of pixel p, whose previous row holds ``prev``, wins its pixel.
__device__ __forceinline__ bool wins(int p, int prev, long long n_pix) {
  return p != prev && p != kNoId && p >= 0 && p < n_pix;
}

__device__ __forceinline__ void merge_row(unsigned long long* fb,
                                          const int* bits, const int* ids,
                                          long long i, int p) {
  const unsigned long long word =
      (static_cast<unsigned long long>(static_cast<unsigned>(__ldg(bits + i)))
       << 32) |
      static_cast<unsigned>(__ldg(ids + i));
  if (word < fb[p]) fb[p] = word;
}

__device__ __forceinline__ void scalar_row(unsigned long long* fb,
                                           long long n_pix, const int* pix,
                                           const int* bits, const int* ids,
                                           long long i) {
  const int p = pix[i];
  if (wins(p, i > 0 ? pix[i - 1] : ~p, n_pix)) merge_row(fb, bits, ids, i, p);
}

// A warp's chunk of the pixel column: a lane's kUnroll vectors (vector
// u * 32 + lane of the chunk), and on lane 0 the row before the chunk.
struct Chunk {
  int4 v[kUnroll];
  int before;
};

__device__ __forceinline__ void load_chunk(Chunk& ch, const int* pix,
                                           const int4* vec, long long nvec,
                                           long long first, long long v0,
                                           int lane) {
  if (v0 + kChunkVecs <= nvec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ch.v[u] = load_streaming(vec + v0 + u * 32 + lane);
  } else {  // the last chunk: rows past the column read as tail
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long vi = v0 + u * 32 + lane;
      ch.v[u] = vi < nvec ? load_streaming(vec + vi)
                          : make_int4(kNoId, kNoId, kNoId, kNoId);
    }
  }
  ch.before = lane == 0 && first > 0 ? __ldg(pix + first - 1) : 0;
}

// Row r of a lane's chunk (row r % 4 of vector r / 4): its pixel.
__device__ __forceinline__ int chunk_pixel(const Chunk& ch, int r) {
  int p = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int4 v = ch.v[u];
    p = r == 4 * u ? v.x : r == 4 * u + 1 ? v.y : r == 4 * u + 2 ? v.z
        : r == 4 * u + 3 ? v.w : p;
  }
  return p;
}

// Merges the winners of a chunk whose first row is ``first``. A lane
// takes its winners one a round, lowest row first, and all lanes of the
// warp load theirs in the same round: a chunk costs the winners' loads
// as many round trips as its busiest lane has winners, nearly always one.
__device__ __forceinline__ void merge_chunk(const Chunk& ch, long long first,
                                            int lane,
                                            unsigned long long* fb,
                                            long long n_pix, const int* bits,
                                            const int* ids) {
  unsigned mask = 0;  // bit r: row r of the lane's chunk wins
  int carry = first > 0 ? ch.before : ~ch.v[0].x;  // lane 0's previous row
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int4 v = ch.v[u];
    const int up = __shfl_up_sync(0xffffffffu, v.w, 1);
    const int prev = lane == 0 ? carry : up;
    carry = __shfl_sync(0xffffffffu, v.w, 31);
    mask |= (wins(v.x, prev, n_pix) ? 1u : 0u) << (4 * u);
    mask |= (wins(v.y, v.x, n_pix) ? 1u : 0u) << (4 * u + 1);
    mask |= (wins(v.z, v.y, n_pix) ? 1u : 0u) << (4 * u + 2);
    mask |= (wins(v.w, v.z, n_pix) ? 1u : 0u) << (4 * u + 3);
  }
  while (mask) {
    const int r = __ffs(mask) - 1;
    mask &= mask - 1;
    merge_row(fb, bits, ids, first + 4 * ((r >> 2) * 32 + lane) + (r & 3),
              chunk_pixel(ch, r));
  }
}

// Rows [0, head) and [head + 4 * nvec, n) one a thread of the first
// block; rows [head, head + 4 * nvec) as int4 vectors, a warp a chunk,
// the next chunk's loads issued before the current chunk's winners.
__global__ void __launch_bounds__(kThreads) sorted_merge_kernel(
    unsigned long long* __restrict__ fb, long long n_pix,
    const int* __restrict__ pix, const int* __restrict__ bits,
    const int* __restrict__ ids, long long n, int head) {
  const long long nvec = (n - head) / 4;
  const long long body_end = head + 4 * nvec;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < head)
    scalar_row(fb, n_pix, pix, bits, ids, t);
  else if (t < head + (n - body_end))
    scalar_row(fb, n_pix, pix, bits, ids, body_end + (t - head));

  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long chunks = (nvec + kChunkVecs - 1) / kChunkVecs;
  const int4* vec = reinterpret_cast<const int4*>(pix + head);
  long long c = t >> 5;
  if (c >= chunks) return;
  Chunk cur;
  load_chunk(cur, pix, vec, nvec, head + 4 * c * kChunkVecs, c * kChunkVecs,
             lane);
  for (;;) {
    const long long next = c + warps;
    // a chunk that ends in _NO_ID: every later chunk of the stride is tail
    const int last = __shfl_sync(0xffffffffu, cur.v[kUnroll - 1].w, 31);
    const bool more = next < chunks && last != kNoId;
    Chunk nxt;
    if (more)
      load_chunk(nxt, pix, vec, nvec, head + 4 * next * kChunkVecs,
                 next * kChunkVecs, lane);
    merge_chunk(cur, head + 4 * c * kChunkVecs, lane, fb, n_pix, bits, ids);
    if (!more) return;
    cur = nxt;
    c = next;
  }
}

}  // namespace

// Merges the sorted columns (pix, bits, ids) of length ``n`` into the
// ``n_pix``-word framebuffer ``fb``. The columns must be sort4's output
// (ascending by pixel): the kernel stops where the _NO_ID tail begins.
// Returns the cudaError_t of the launch.
extern "C" int pc_sorted_merge(unsigned long long* fb, long long n_pix,
                               const int* pix, const int* bits,
                               const int* ids, long long n, void* stream) {
  if (n < 1 || n_pix < 1) return cudaErrorInvalidValue;
  const long long to_boundary =
      ((16 - (reinterpret_cast<std::uintptr_t>(pix) & 15)) & 15) / 4;
  const int head = static_cast<int>(to_boundary < n ? to_boundary : n);
  const long long chunks = ((n - head) / 4 + kChunkVecs - 1) / kChunkVecs;
  // a persistent grid on the current device, at most kInFlightBytes of
  // loads a SM, and no more blocks than chunks need (at least one, for
  // the scalar rows)
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sorted_merge_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kFill = kInFlightBytes / (kThreads * 16 * kUnroll);
  const long long resident =
      static_cast<long long>(sms) *
      (per_sm < kFill ? (per_sm > 0 ? per_sm : 1) : (kFill > 0 ? kFill : 1));
  const long long needed = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const long long blocks =
      needed < 1 ? 1 : (needed < resident ? needed : resident);
  sorted_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fb, n_pix, pix, bits, ids, n, head);
  return static_cast<int>(cudaGetLastError());
}
