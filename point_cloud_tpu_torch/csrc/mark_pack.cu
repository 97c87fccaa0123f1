// mark_pack.cu — B3, the dedup pass's back end, for Hopper (sm_90a).
//
// Replaces the back half of the reference's fused light pass,
// point_cloud_tpu/ops/dedup.py _dedup_light_body (:351-422) with
// _near_tie_mask (:51-81), which _dedup_resident_body (:428-452) shares.
// The port ran it as some forty eager torch launches, among them torch's
// CUDA cumsum, cummax and a flipped cummin.
//
// Input: the four columns sort4 left (cell hash, slot hash, distance bits,
// perm) and the positions perm indexes. Output, per sorted row,
// perm | winner << 30 | suspect << 29, where
//   first    = row 0, or a (cell hash, slot hash) pair unlike the row
//              before's; valid = cell hash != i32::MAX; winner = first &
//              valid;
//   mismatch = not first, valid, and either the true keys (recomputed
//              from positions[perm] with B2's arithmetic, hex_keys.cuh)
//              differ from the row before's, or the distances nearly tie:
//              bits within 8, or d - d_prev <= 2^-18 * max|p| * sqrt(d);
//   suspect  = some row of the row's run (its rows from one first to the
//              next) has a mismatch, and valid.
// Row 0 has no predecessor: it is first and carries no mismatch, which is
// what the reference's roll-then-clear gives it.
//
// The hard part is the run spread: a run has any length (every row of a
// bucket can be one run) and crosses any tile. Two launches, linear work:
// - mark_pack_tiles: a block takes 512 rows, one a thread. It computes the
//   flags, gathers them into warp ballots in shared memory, and for each
//   row ORs the mismatch bits of its run inside the tile with a handful of
//   bit operations (or_back / or_ahead: the nearest run start at or before
//   the row, the nearest run end at or after it, found with clz and ffs
//   over the ballot words and a mask of the nonzero words). It writes the
//   packed row with that tile-local suspect bit, and a summary of the tile:
//   whether a run starts in it, where the first and last starts are, the
//   mismatch OR of its head (rows before the first start) and of its tail
//   (rows from the last start). The last block to finish (an atomic ticket
//   after a fence) runs the segmented OR over the tile summaries, forward
//   (carry in: the OR of the run that enters the tile) and backward (carry
//   out: the OR of the run that leaves it), with the same bit operations
//   across its threads' chunks of tiles.
// - mark_pack_resolve: a block reads its tile's carries; where one is set
//   it adds the suspect bit to the head or tail rows it covers. Most tiles
//   have none and leave at once.
// No cumsum, cummax, cummin or scatter: every row is written twice at most,
// the tile scan touches 4 B a tile, and nothing is quadratic in a run.
// The ticket is zeroed by a 4-byte memset before the first launch.
//
// Arithmetic: the keys and the near-tie threshold are IEEE f32 with _rn
// intrinsics in the torch twins' order (no fma); max|p| propagates NaN as
// torch.amax does, and max(d, 0) keeps a NaN d as torch.clamp_min does.
//
// What bounds it: bytes, 32 a row (16 B of sorted columns, 12 B of
// positions gathered through perm, 4 B written): 10 us at 2^20 rows at
// 3.35 TB/s. The gathers are scattered 12-byte reads, which move whole
// 32-byte sectors; the keys cost ~80 operations a row where a row shares
// its hash pair with a neighbour.

#include <cuda_runtime.h>

#include "hex_keys.cuh"

namespace {

constexpr int kThreads = 512;  // rows a tile, one a thread
constexpr int kWords = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNearTieUlps = 8;
constexpr float kNearTieScale = 3.814697265625e-06f;  // 64 * 2^-24 = 2^-18

// summary word of a tile: has_start | head_or << 1 | tail_or << 2 |
// first_start << 3 | last_start << 13 (starts are row offsets in the tile,
// kThreads when there is none)
constexpr int kFirstShift = 3;
constexpr int kLastShift = 13;
constexpr int kStartMask = 1023;

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned bits_le(int b) {  // bits 0..b, b <= 31
  return b >= 31 ? kFull : (2u << b) - 1u;
}

__device__ __forceinline__ unsigned bits_lt(int b) {  // bits 0..b-1, b <= 31
  return (1u << b) - 1u;
}

// A sequence of at most 32 x 32 positions: bit b of word w is position
// 32 w + b. ``f`` marks segment bounds, ``m`` the values; ``nz_f`` and
// ``nz_m`` have bit w set where word w of f or m is nonzero.
struct Bits {
  const unsigned* f;
  const unsigned* m;
  unsigned nz_f, nz_m;
};

// OR of m over [s, p], s the last position <= p where f is set, or 0 when
// there is none; *found says whether there was one.
__device__ __forceinline__ bool or_back(const Bits& x, int p, bool* found) {
  const int w = p >> 5;
  const unsigned le = bits_le(p & 31);
  const unsigned fw = x.f[w] & le;
  if (fw) {
    *found = true;
    return (x.m[w] & le & ~bits_lt(31 - __clz(fw))) != 0;
  }
  bool v = (x.m[w] & le) != 0;
  const unsigned below = bits_lt(w);  // the words before w
  const unsigned starts = x.nz_f & below;
  *found = starts != 0;
  if (starts) {
    const int ws = 31 - __clz(starts);
    const int s = 31 - __clz(x.f[ws]);
    return v || (x.nz_m & below & ~bits_le(ws)) != 0 ||
           (x.m[ws] & ~bits_lt(s)) != 0;
  }
  return v || (x.nz_m & below) != 0;
}

// OR of m over [p, e], e the first position >= p where f is set, or the
// last position when there is none; *found says whether there was one.
__device__ __forceinline__ bool or_ahead(const Bits& x, int p, bool* found) {
  const int w = p >> 5;
  const unsigned ge = ~bits_lt(p & 31);
  const unsigned fw = x.f[w] & ge;
  if (fw) {
    *found = true;
    return (x.m[w] & ge & bits_le(__ffs(fw) - 1)) != 0;
  }
  bool v = (x.m[w] & ge) != 0;
  const unsigned above = ~bits_le(w);  // the words after w
  const unsigned ends = x.nz_f & above;
  *found = ends != 0;
  if (ends) {
    const int we = __ffs(ends) - 1;
    const int e = __ffs(x.f[we]) - 1;
    return v || (x.nz_m & above & bits_lt(we)) != 0 ||
           (x.m[we] & bits_le(e)) != 0;
  }
  return v || (x.nz_m & above) != 0;
}

// Every thread of the block calls it: the block's ballots of f and m into
// sf/sm (one word a warp) and their nonzero-word masks into nz[0..1].
__device__ __forceinline__ void ballot_bits(bool f, bool m, unsigned* sf,
                                            unsigned* sm, unsigned* nz) {
  const unsigned bf = __ballot_sync(kFull, f);
  const unsigned bm = __ballot_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) {
    sf[threadIdx.x >> 5] = bf;
    sm[threadIdx.x >> 5] = bm;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const unsigned nf = __ballot_sync(kFull, l < kWords && sf[l] != 0);
    const unsigned nm = __ballot_sync(kFull, l < kWords && sm[l] != 0);
    if (l == 0) {
      nz[0] = nf;
      nz[1] = nm;
    }
  }
  __syncthreads();
}

// The true keys of row ``r`` (cell index and slot) into column ``slot`` of
// the shared key table.
__device__ __forceinline__ void row_keys(const float* positions, const int* perm,
                                         long long r, float cs, float rad,
                                         int (*key)[kThreads + 1], int slot,
                                         float* p) {
  const float* q = positions + 3LL * __ldg(perm + r);
  p[0] = __ldg(q);
  p[1] = __ldg(q + 1);
  p[2] = __ldg(q + 2);
  const pc_hex::Keys k = pc_hex::hex_keys<false>(p[0], p[1], p[2], cs, rad);
  for (int c = 0; c < 3; ++c) {
    key[c][slot] = k.cell[c];
    key[3 + c][slot] = k.sub[c];
  }
}

// The last block's segmented ORs over the tile summaries: carry bit 0 =
// the mismatch OR of the run entering tile j from the tiles before it,
// bit 1 = that of the run leaving it into the tiles after it.
__device__ void scan_tiles(const int* summary, int* carry, int tiles,
                           unsigned* sf, unsigned* sm, unsigned* nz) {
  const int tid = threadIdx.x;
  const int per = (tiles + kThreads - 1) / kThreads;
  const int j0 = min(tid * per, tiles), j1 = min(j0 + per, tiles);
  bool found;

  // forward: the tail ORs since the last tile where a run starts
  bool r = false, v = false;
  for (int j = j0; j < j1; ++j) {
    const int s = __ldcg(summary + j);
    const bool tail = (s >> 2) & 1;
    r = r || (s & 1);
    v = (s & 1) ? tail : (v || tail);
  }
  ballot_bits(r, v, sf, sm, nz);
  bool in = tid > 0 && or_back(Bits{sf, sm, nz[0], nz[1]}, tid - 1, &found);
  for (int j = j0; j < j1; ++j) {
    const int s = __ldcg(summary + j);
    carry[j] = in;
    const bool tail = (s >> 2) & 1;
    in = (s & 1) ? tail : (in || tail);
  }
  __syncthreads();  // the shared words are reused

  // backward: the head ORs up to the next tile where a run starts
  r = false;
  v = false;
  for (int j = j1 - 1; j >= j0; --j) {
    const int s = __ldcg(summary + j);
    const bool head = (s >> 1) & 1;
    r = r || (s & 1);
    v = (s & 1) ? head : (v || head);
  }
  ballot_bits(r, v, sf, sm, nz);
  bool out = tid + 1 < kThreads &&
             or_ahead(Bits{sf, sm, nz[0], nz[1]}, tid + 1, &found);
  for (int j = j1 - 1; j >= j0; --j) {
    const int s = __ldcg(summary + j);
    carry[j] |= static_cast<int>(out) << 1;
    const bool head = (s >> 1) & 1;
    out = (s & 1) ? head : (out || head);
  }
}

__global__ void __launch_bounds__(kThreads) mark_pack_tiles(
    const int* __restrict__ ch, const int* __restrict__ sh,
    const int* __restrict__ db, const int* __restrict__ perm,
    const float* __restrict__ positions, const float* __restrict__ cell_size,
    const float* __restrict__ radius, long long n, int tiles,
    int* __restrict__ out, int* summary, int* carry, unsigned* ticket) {
  __shared__ int key[6][kThreads + 1];  // column 0: the row before the tile
  __shared__ unsigned s_f[kWords], s_m[kWords], s_l[kWords], s_nz[3];
  __shared__ int s_head, s_tail, s_last_block;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const long long i = base + tid;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads), n - base));
  const bool in = tid < rows;
  const float cs = __ldg(cell_size), rad = __ldg(radius);

  int c = 0;
  bool valid = false, same_prev = false, same_next = false;
  if (in) {
    c = __ldg(ch + i);
    const int s = __ldg(sh + i);
    valid = c != INT_MAX;
    same_prev = i > 0 && __ldg(ch + i - 1) == c && __ldg(sh + i - 1) == s;
    same_next = i + 1 < n && __ldg(ch + i + 1) == c && __ldg(sh + i + 1) == s;
  }
  const bool first = in && !same_prev;
  const bool audit = in && valid && same_prev;  // mismatch can be set

  // true keys: only rows that share their hash pair with a neighbour
  float p[3] = {0.0f, 0.0f, 0.0f}, q[3];
  if (in && valid && (same_prev || same_next))
    row_keys(positions, perm, i, cs, rad, key, tid + 1, p);
  if (tid == 0 && audit) row_keys(positions, perm, i - 1, cs, rad, key, 0, q);
  __syncthreads();

  bool mis = false;
  if (audit) {
    bool diff = false;
    for (int k = 0; k < 6; ++k) diff = diff || key[k][tid + 1] != key[k][tid];
    const int d = __ldg(db + i), dp = __ldg(db + i - 1);
    const int gap = static_cast<int>(static_cast<unsigned>(d) - static_cast<unsigned>(dp));
    const float df = __int_as_float(d), dpf = __int_as_float(dp);
    const float pmax = max_nan(max_nan(fabsf(p[0]), fabsf(p[1])), fabsf(p[2]));
    const float dc = df != df ? df : fmaxf(df, 0.0f);
    const float thr = pc_hex::mul(pc_hex::mul(kNearTieScale, pmax), __fsqrt_rn(dc));
    mis = diff || gap <= kNearTieUlps || pc_hex::sub(df, dpf) <= thr;
  }

  // run starts and mismatches as ballot words; run ends (the next row
  // starts a run) shifted from the starts, unknown past the tile's end
  ballot_bits(first, mis, s_f, s_m, s_nz);
  if (tid < 32) {
    const unsigned f = tid < kWords ? s_f[tid] : 0u;
    const unsigned fn = tid + 1 < kWords ? s_f[tid + 1] : 0u;
    const unsigned l = (f >> 1) | ((fn & 1u) << 31);
    if (tid < kWords) s_l[tid] = l;
    const unsigned nl = __ballot_sync(kFull, l != 0);
    if (tid == 0) s_nz[2] = nl;
  }
  __syncthreads();

  bool closed;
  const bool back = or_back(Bits{s_f, s_m, s_nz[0], s_nz[1]}, tid, &closed);
  const bool ahead = or_ahead(Bits{s_l, s_m, s_nz[2], s_nz[1]}, tid, &closed);
  if (in) {
    out[i] = __ldg(perm + i) | (static_cast<int>(first && valid) << 30) |
             (static_cast<int>((back || ahead) && valid) << 29);
  }
  if (tid == 0) s_head = first ? 0 : ahead;  // rows before the first start
  if (tid == rows - 1) s_tail = back;        // rows from the last start
  __syncthreads();

  if (tid == 0) {
    const unsigned nf = s_nz[0];
    int first_start = kThreads, last_start = kThreads;
    if (nf) {
      const int w0 = __ffs(nf) - 1, w1 = 31 - __clz(nf);
      first_start = 32 * w0 + __ffs(s_f[w0]) - 1;
      last_start = 32 * w1 + 31 - __clz(s_f[w1]);
    }
    summary[blockIdx.x] = static_cast<int>(nf != 0) | (s_head << 1) |
                          (s_tail << 2) | (first_start << kFirstShift) |
                          (last_start << kLastShift);
    __threadfence();  // the summary is visible before the ticket counts it
    s_last_block = atomicAdd(ticket, 1u) == static_cast<unsigned>(tiles - 1);
  }
  __syncthreads();
  if (!s_last_block) return;
  __threadfence();
  scan_tiles(summary, carry, tiles, s_f, s_m, s_nz);
}

__global__ void __launch_bounds__(kThreads) mark_pack_resolve(
    const int* __restrict__ summary, const int* __restrict__ carry, long long n,
    int* __restrict__ out) {
  const int c = __ldg(carry + blockIdx.x);
  if (c == 0) return;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = __ldg(summary + blockIdx.x);
  const int tid = threadIdx.x;
  const int first_start = (s >> kFirstShift) & kStartMask;
  const int last_start = (s >> kLastShift) & kStartMask;
  // no start in the tile: every row is in the run that crosses it
  const bool flag = !(s & 1) || (tid < first_start && (c & 1)) ||
                    (tid >= last_start && (c & 2));
  if (flag) out[i] |= 1 << 29;
}

}  // namespace

// Returns a cudaError_t. n in [1, 2^29] (perm must fit below the flag
// bits); ``scratch`` holds 2 * ceil(n / 512) + 1 ints: the tile summaries,
// their carries and the ticket.
extern "C" int pc_mark_pack(const int* ch, const int* sh, const int* db,
                            const int* perm, const float* positions,
                            const float* cell_size, const float* radius,
                            long long n, int* out, int* scratch,
                            void* stream_handle) {
  if (n < 1 || n > (1LL << 29)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int tiles = static_cast<int>((n + kThreads - 1) / kThreads);
  int* summary = scratch;
  int* carry = scratch + tiles;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 2LL * tiles);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_pack_tiles<<<tiles, kThreads, 0, stream>>>(
      ch, sh, db, perm, positions, cell_size, radius, n, tiles, out, summary,
      carry, ticket);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_pack_resolve<<<tiles, kThreads, 0, stream>>>(summary, carry, n, out);
  return static_cast<int>(cudaGetLastError());
}
