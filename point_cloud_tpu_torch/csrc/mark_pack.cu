// mark_pack.cu — B3, the dedup pass's back end, for Hopper (sm_90a).
//
// Replaces the back half of the reference's fused light pass,
// point_cloud_tpu/ops/dedup.py _dedup_light_body (:351-422) with
// _near_tie_mask (:51-81), which _dedup_resident_body (:428-452) shares,
// and the same flags of the owner cascade's _winner_and_suspect
// (point_cloud_tpu/parallel/owner_cascade.py:70-111).
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
// One launch a call, no memset. A block takes a tile of 1,024 rows, two or
// four a thread (kFewRows): each column arrives as one 8- or 16-byte load a
// thread, the neighbours at i-1 and i+1 come from warp shuffles (across warps through shared
// memory, across tiles from one halo row at each edge), and every
// positions[perm] gather of a thread is issued before any key arithmetic.
// The run spread is a single-pass chained scan over the tiles, a
// decoupled look-back (Merrill and Garland, 2016):
// - inside the tile, run starts, run ends and mismatches become 32 ballot
//   words; each row ORs the mismatches of its run's part in the tile with
//   clz/ffs over those words (or_back / or_ahead) and is stored with that
//   tile-local suspect bit, then fenced;
// - the tile then publishes a status word: with a run start, the index of
//   its last start and the mismatch OR from there to its end (an inclusive
//   prefix); without one, its own OR (an aggregate), and, once its
//   look-back resolves, the prefix;
// - a tile whose first row continues a run looks back over its
//   predecessors' words, a warp reading 32 at once, to the nearest prefix:
//   that gives the run's start row and the OR of its rows before the tile.
//   If the run ends in this tile (a start follows, or the tile is the
//   array's last), the tile knows the run's whole OR and, if it is set,
//   sets bit 29 with atomicOr on the run's rows in the earlier tiles (they
//   were stored and fenced before their tiles published) and, if the part
//   before it was set, on its own head rows.
// Every row is written at most twice, and no block waits on a later one.
// Tile numbers come from a tile counter in the order blocks start, so the
// tiles a block waits on belong to blocks already running. The counter
// and the status words live in a scratch that the wrapper keeps per
// (device, stream) and zeroes once: a call passes the counter's value at
// its start (``base``: each call adds ``tiles``) and a call tag
// (``epoch``, never 0) that its status words carry, so no word needs
// clearing between calls.
//
// Arithmetic: the keys and the near-tie threshold are IEEE f32 with _rn
// intrinsics in the torch twins' order (no fma); max|p| propagates NaN as
// torch.amax does, and max(d, 0) keeps a NaN d as torch.clamp_min does.
// The keys' divisors are hex_keys.cuh's Grid, built once a block in shared
// memory (the divisions themselves equal __fdiv_rn bit for bit).
//
// What bounds it: bytes, 16 B a row of sorted columns read and 4 B written,
// plus 12 B of position gathered through perm for each row that shares its
// hash pair with a neighbour (~80 f32 operations there): 8.3 us at 2^20
// rows of the LiDAR-like cloud at 3.35 TB/s. The gathers are scattered
// 12-byte reads through the read-only path, which move whole 32-byte
// sectors, mostly from L2 (B2 streamed the positions just before sort4).
// On the H100 a tile's chain of dependent round trips (its columns, the
// gathers through perm, the key arithmetic, its stores and status) holds
// it near 10 us a wave of tiles, whatever the run spread costs: one wave
// at 2^18 rows, three at 2^20. Loading each position as one or two 16-byte
// chunks was slower than three 4-byte loads; a block-index tile order or
// one fence a block in place of the tile counter and a fence a thread
// changed nothing measurable.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hex_keys.cuh"

namespace {

constexpr int kTileRows = 1024;
constexpr int kWords = kTileRows / 32;  // ballot words a tile
static_assert(kWords == 32, "or_back / or_ahead take 32 words of 32 rows");
// Rows a thread (kRows, 2 or 4; a block has kTileRows / kRows threads):
// at up to kFewRows rows the tiles fit in one wave of 512-thread blocks,
// and two rows a thread shorten a tile's serial chain; above it four rows
// a thread keep twice the rows resident. On the H100 (tools/kernel_ab.py
// pass, the LiDAR-like cloud): 10.2 against 12.4 us at 2^18 rows, 34.7
// against 32.2 at 2^20 and 152 against 125 at 2^22.
constexpr long long kFewRows = 1LL << 18;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNearTieUlps = 8;
constexpr float kNearTieScale = 3.814697265625e-06f;  // 64 * 2^-24 = 2^-18
constexpr int kSuspect = 1 << 29;

// A tile's status word: epoch << 32 | payload. The payload holds kPrefix
// (an inclusive prefix; else the aggregate of a tile without a run start),
// kOrBit (the mismatch OR) and, in a prefix, the start row of the run that
// leaves the tile.
constexpr unsigned kPrefix = 1u << 31;
constexpr unsigned kOrBit = 1u << 29;
constexpr unsigned kIndexMask = (1u << 29) - 1;
// Polls of a predecessor's word before the kernel gives up (~20 s): the
// tile it waits on belongs to a block already running, so only a scratch
// that another call shares can keep it waiting.
constexpr unsigned kSpinLimit = 1u << 27;

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

// A sequence of 32 x 32 positions: bit b of word w is position 32 w + b.
// ``f`` marks segment bounds, ``m`` the values; ``nz_f`` and ``nz_m`` have
// bit w set where word w of f or m is nonzero.
struct Bits {
  const unsigned* f;
  const unsigned* m;
  unsigned nz_f, nz_m;
};

// OR of m over [s, p], s the last position <= p where f is set, or 0 when
// there is none.
__device__ __forceinline__ bool or_back(const Bits& x, int p) {
  const int w = p >> 5;
  const unsigned le = bits_le(p & 31);
  const unsigned fw = x.f[w] & le;
  if (fw) return (x.m[w] & le & ~bits_lt(31 - __clz(fw))) != 0;
  const bool v = (x.m[w] & le) != 0;
  const unsigned below = bits_lt(w);  // the words before w
  const unsigned starts = x.nz_f & below;
  if (starts) {
    const int ws = 31 - __clz(starts);
    const int s = 31 - __clz(x.f[ws]);
    return v || (x.nz_m & below & ~bits_le(ws)) != 0 ||
           (x.m[ws] & ~bits_lt(s)) != 0;
  }
  return v || (x.nz_m & below) != 0;
}

// OR of m over [p, e], e the first position >= p where f is set, or the
// last position when there is none.
__device__ __forceinline__ bool or_ahead(const Bits& x, int p) {
  const int w = p >> 5;
  const unsigned ge = ~bits_lt(p & 31);
  const unsigned fw = x.f[w] & ge;
  if (fw) return (x.m[w] & ge & bits_le(__ffs(fw) - 1)) != 0;
  const bool v = (x.m[w] & ge) != 0;
  const unsigned above = ~bits_le(w);  // the words after w
  const unsigned ends = x.nz_f & above;
  if (ends) {
    const int we = __ffs(ends) - 1;
    const int e = __ffs(x.f[we]) - 1;
    return v || (x.nz_m & above & bits_lt(we)) != 0 ||
           (x.m[we] & bits_le(e)) != 0;
  }
  return v || (x.nz_m & above) != 0;
}

// The true keys of a position: cell index, then hex slot.
__device__ __forceinline__ void row_keys(const float* p, const pc_hex::Grid& g,
                                         int* key) {
  const pc_hex::Keys k = pc_hex::hex_keys<false>(p[0], p[1], p[2], g);
  for (int c = 0; c < 3; ++c) {
    key[c] = k.cell[c];
    key[3 + c] = k.sub[c];
  }
}

// ``in`` rows of a column from row i (vector loads when all kRows are in
// range and the column is 16-byte aligned), 0 past them.
template <int kRows, bool kVec>
__device__ __forceinline__ void load_rows(const int* __restrict__ col,
                                          long long i, int in, int* v) {
  constexpr int kVecInts = kRows < 4 ? kRows : 4;  // ints a vector load
  if (kVec && in == kRows) {
    for (int k = 0; k < kRows; k += kVecInts) {
      if constexpr (kVecInts == 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(col + i + k));
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
      } else {
        const int2 q = __ldg(reinterpret_cast<const int2*>(col + i + k));
        v[k] = q.x;
        v[k + 1] = q.y;
      }
    }
  } else {
    for (int k = 0; k < kRows; ++k) v[k] = k < in ? __ldg(col + i + k) : 0;
  }
}

template <int kRows, bool kVec>
__device__ __forceinline__ void store_rows(int* out, long long i, int in,
                                           const int* v) {
  constexpr int kVecInts = kRows < 4 ? kRows : 4;
  if (kVec && in == kRows) {
    for (int k = 0; k < kRows; k += kVecInts) {
      if constexpr (kVecInts == 4) {
        *reinterpret_cast<int4*>(out + i + k) =
            make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      } else {
        *reinterpret_cast<int2*>(out + i + k) = make_int2(v[k], v[k + 1]);
      }
    }
  } else {
    for (int k = 0; k < kRows; ++k)
      if (k < in) out[i + k] = v[k];
  }
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned epoch, unsigned payload) {
  const unsigned long long v =
      (static_cast<unsigned long long>(epoch) << 32) | payload;
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(word)
               : "memory");
  return v;
}

// Warp 0 of ``tile``: the start row of the run that enters the tile and
// whether its rows before the tile hold a mismatch, from the status words
// of the tiles before it, 32 at a time, back to the nearest prefix. Tile 0
// always publishes a prefix (its row 0 starts a run), so the walk ends.
__device__ __forceinline__ void look_back(const unsigned long long* status,
                                          int tile, unsigned epoch,
                                          unsigned* start, bool* any) {
  const int lane = threadIdx.x & 31;
  bool acc = false;
  for (int j = tile - 1 - lane;; j -= 32) {
    unsigned pay = kPrefix;  // before tile 0 (never the nearest prefix)
    if (j >= 0) {
      unsigned long long v;
      for (unsigned tries = 0;; ++tries) {
        v = observe(status + j);
        if (static_cast<unsigned>(v >> 32) == epoch) break;
        if (tries >= kSpinLimit) __trap();  // a broken scratch: fail, not hang
        if (tries >= 8) __nanosleep(128);
      }
      pay = static_cast<unsigned>(v);
    }
    const unsigned prefixes = __ballot_sync(kFull, (pay & kPrefix) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    const bool hit = __any_sync(kFull, lane <= stop && (pay & kOrBit));
    acc = acc || hit;
    if (prefixes) {
      *start = __shfl_sync(kFull, pay & kIndexMask, stop);
      *any = acc;
      return;
    }
  }
}

// kRows blocks an SM at least: at most 64 registers a thread
template <int kRows, bool kVec>
__global__ void __launch_bounds__(kTileRows / kRows, kRows) mark_pack_kernel(
    const int* __restrict__ ch, const int* __restrict__ sh,
    const int* __restrict__ db, const int* __restrict__ perm,
    const float* __restrict__ positions, const float* __restrict__ cell_size,
    const float* __restrict__ radius, long long n, int* out,
    unsigned long long* status, unsigned* counter, unsigned base,
    unsigned epoch) {
  static_assert(kRows == 2 || kRows == 4, "rows a thread");
  constexpr int kThreads = kTileRows / kRows;
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanesPerWord = 32 / kRows;  // lanes that fill a word
  __shared__ int s_last[kWarps][3];   // each warp's last row: ch, sh, db
  __shared__ int s_first[kWarps][2];  // each warp's first row: ch, sh
  __shared__ int s_keys[kWarps][6];   // the true keys of each warp's last row
  __shared__ unsigned s_f[kWords], s_m[kWords], s_l[kWords];
  __shared__ int s_tile;
  __shared__ long long s_fix[3];  // earlier rows [0], [1]; own rows below [2]
  __shared__ pc_hex::Grid s_grid;  // the divisors, built once a block

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u) - base);
  // warp 1 builds the divisors while thread 0 waits on the counter
  if (tid == 32) s_grid = pc_hex::make_grid(__ldg(cell_size), __ldg(radius));
  __syncthreads();
  const int tile = s_tile;
  const long long begin = static_cast<long long>(tile) * kTileRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kTileRows),
                                        n - begin));
  const int r0 = tid * kRows;  // the tile row of this thread's first row
  const long long i0 = begin + r0;
  const int in = max(0, min(kRows, rows - r0));  // of its rows in the array

  int c[kRows], s[kRows], d[kRows], pm[kRows];
  load_rows<kRows, kVec>(ch, i0, in, c);
  load_rows<kRows, kVec>(sh, i0, in, s);
  load_rows<kRows, kVec>(db, i0, in, d);
  load_rows<kRows, kVec>(perm, i0, in, pm);
  // the halo rows: before the tile (thread 0) and after it (the last one)
  int pc = 0, ps = 0, pd = 0, hp = 0, nc = 0, ns = 0;
  if (tid == 0 && begin > 0) {
    pc = __ldg(ch + begin - 1);
    ps = __ldg(sh + begin - 1);
    pd = __ldg(db + begin - 1);
    hp = __ldg(perm + begin - 1);
  }
  if (tid == kThreads - 1 && begin + kTileRows < n) {
    nc = __ldg(ch + begin + kTileRows);
    ns = __ldg(sh + begin + kTileRows);
  }

  // the rows at i0 - 1 and i0 + kRows
  if (lane == 31) {
    s_last[warp][0] = c[kRows - 1];
    s_last[warp][1] = s[kRows - 1];
    s_last[warp][2] = d[kRows - 1];
  }
  if (lane == 0) {
    s_first[warp][0] = c[0];
    s_first[warp][1] = s[0];
  }
  {
    const int uc = __shfl_up_sync(kFull, c[kRows - 1], 1);
    const int us = __shfl_up_sync(kFull, s[kRows - 1], 1);
    const int ud = __shfl_up_sync(kFull, d[kRows - 1], 1);
    const int dc = __shfl_down_sync(kFull, c[0], 1);
    const int ds = __shfl_down_sync(kFull, s[0], 1);
    if (lane > 0) {
      pc = uc;
      ps = us;
      pd = ud;
    }
    if (lane < 31) {
      nc = dc;
      ns = ds;
    }
  }
  __syncthreads();
  if (lane == 0 && warp > 0) {
    pc = s_last[warp - 1][0];
    ps = s_last[warp - 1][1];
    pd = s_last[warp - 1][2];
  }
  if (lane == 31 && warp < kWarps - 1) {
    nc = s_first[warp + 1][0];
    ns = s_first[warp + 1][1];
  }

  // run starts, and the rows whose keys a row of their pair compares
  bool first[kRows], same_prev[kRows], same_next[kRows], valid[kRows],
      keyed[kRows];
  for (int k = 0; k < kRows; ++k) {
    const long long i = i0 + k;
    const bool here = k < in;
    const int pck = k ? c[k - 1] : pc, psk = k ? s[k - 1] : ps;
    const int nck = k + 1 < kRows ? c[k + 1] : nc;
    const int nsk = k + 1 < kRows ? s[k + 1] : ns;
    valid[k] = c[k] != INT_MAX;
    same_prev[k] = here && i > 0 && pck == c[k] && psk == s[k];
    same_next[k] = here && i + 1 < n && nck == c[k] && nsk == s[k];
    first[k] = here && !same_prev[k];
    keyed[k] = here && valid[k] && (same_prev[k] || same_next[k]);
  }
  const bool halo_keyed = tid == 0 && same_prev[0] && valid[0];

  // every gather first, then the keys
  float p[kRows][3], hpos[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kRows; ++k) {
    if (keyed[k]) {
      const float* q = positions + 3LL * pm[k];
      p[k][0] = __ldg(q);
      p[k][1] = __ldg(q + 1);
      p[k][2] = __ldg(q + 2);
    } else {
      p[k][0] = p[k][1] = p[k][2] = 0.0f;
    }
  }
  if (halo_keyed) {
    const float* q = positions + 3LL * hp;
    hpos[0] = __ldg(q);
    hpos[1] = __ldg(q + 1);
    hpos[2] = __ldg(q + 2);
  }
  int last_key[6] = {0, 0, 0, 0, 0, 0}, prev_key[6];
  if (keyed[kRows - 1]) row_keys(p[kRows - 1], s_grid, last_key);
  if (lane == 31)
    for (int j = 0; j < 6; ++j) s_keys[warp][j] = last_key[j];
  for (int j = 0; j < 6; ++j)
    prev_key[j] = __shfl_up_sync(kFull, last_key[j], 1);
  if (halo_keyed) row_keys(hpos, s_grid, prev_key);
  __syncthreads();
  if (lane == 0 && warp > 0)
    for (int j = 0; j < 6; ++j) prev_key[j] = s_keys[warp - 1][j];

  // mismatches: a key change or a near-tie with the row before
  bool mis[kRows];
  int dp = pd;
  for (int k = 0; k < kRows; ++k) {
    int key[6];
    if (k == kRows - 1) {
      for (int j = 0; j < 6; ++j) key[j] = last_key[j];
    } else if (keyed[k]) {
      row_keys(p[k], s_grid, key);
    } else {
      for (int j = 0; j < 6; ++j) key[j] = prev_key[j];
    }
    mis[k] = false;
    if (same_prev[k] && valid[k]) {
      bool diff = false;
      for (int j = 0; j < 6; ++j) diff = diff || key[j] != prev_key[j];
      const int gap = static_cast<int>(static_cast<unsigned>(d[k]) -
                                       static_cast<unsigned>(dp));
      const float df = __int_as_float(d[k]), dpf = __int_as_float(dp);
      const float pmax =
          max_nan(max_nan(fabsf(p[k][0]), fabsf(p[k][1])), fabsf(p[k][2]));
      const float dc = df != df ? df : fmaxf(df, 0.0f);
      const float thr =
          pc_hex::mul(pc_hex::mul(kNearTieScale, pmax), __fsqrt_rn(dc));
      mis[k] = diff || gap <= kNearTieUlps || pc_hex::sub(df, dpf) <= thr;
    }
    for (int j = 0; j < 6; ++j) prev_key[j] = key[j];
    dp = d[k];
  }

  // run starts, run ends (the next row starts a run or there is none) and
  // mismatches as ballot words: a thread's rows are kRows bits of a word
  unsigned wf = 0, wm = 0, wl = 0;
  for (int k = 0; k < kRows; ++k) {
    wf |= static_cast<unsigned>(first[k]) << k;
    wm |= static_cast<unsigned>(mis[k]) << k;
    wl |= static_cast<unsigned>(k < in && !same_next[k]) << k;
  }
  const int shift = kRows * (lane % kLanesPerWord);
  wf <<= shift;
  wm <<= shift;
  wl <<= shift;
  for (int o = 1; o < kLanesPerWord; o <<= 1) {
    wf |= __shfl_xor_sync(kFull, wf, o);
    wm |= __shfl_xor_sync(kFull, wm, o);
    wl |= __shfl_xor_sync(kFull, wl, o);
  }
  if (lane % kLanesPerWord == 0) {
    const int w = warp * kRows + lane / kLanesPerWord;
    s_f[w] = wf;
    s_m[w] = wm;
    s_l[w] = wl;
  }
  __syncthreads();
  const unsigned nz_f = __ballot_sync(kFull, s_f[lane] != 0);
  const unsigned nz_m = __ballot_sync(kFull, s_m[lane] != 0);
  const unsigned nz_l = __ballot_sync(kFull, s_l[lane] != 0);

  // each row: the OR of its run's part in the tile, from the part before
  // the thread's rows (or_back), its rows, and the part after (or_ahead)
  const bool before = tid > 0 && or_back(Bits{s_f, s_m, nz_f, nz_m}, r0 - 1);
  const bool after = same_next[kRows - 1] && tid + 1 < kThreads &&
                     or_ahead(Bits{s_l, s_m, nz_l, nz_m}, r0 + kRows);
  bool fwd[kRows];
  bool run = before;
  for (int k = 0; k < kRows; ++k) {
    run = (run && !first[k]) || mis[k];
    fwd[k] = run;
  }
  int packed[kRows];
  run = after;
  for (int k = kRows - 1; k >= 0; --k) {
    if (k + 1 < kRows && first[k + 1]) run = false;
    run = run || mis[k];
    packed[k] = pm[k] | (static_cast<int>(first[k] && valid[k]) << 30) |
                (static_cast<int>((fwd[k] || run) && valid[k]) << 29);
  }
  store_rows<kRows, kVec>(out, i0, in, packed);
  __threadfence();  // the rows are visible before the tile's status
  __syncthreads();

  if (warp == 0) {
    // the tile's summary: its first and last run start, the mismatch OR
    // of its head (rows before the first start) and of its tail (rows
    // from the last start)
    const bool has_start = nz_f != 0;
    int first_start = rows, last_start = 0;
    if (has_start) {
      const int w0 = __ffs(nz_f) - 1, w1 = 31 - __clz(nz_f);
      first_start = 32 * w0 + __ffs(s_f[w0]) - 1;
      last_start = 32 * w1 + 31 - __clz(s_f[w1]);
    }
    const int lo = 32 * lane;
    const unsigned head_mask =
        first_start >= lo + 32 ? kFull
                               : (first_start <= lo ? 0u : bits_lt(first_start - lo));
    const unsigned tail_mask =
        last_start <= lo ? kFull
                         : (last_start >= lo + 32 ? 0u : ~bits_lt(last_start - lo));
    const bool head_or = __any_sync(kFull, (s_m[lane] & head_mask) != 0);
    const bool tail_or = __any_sync(kFull, (s_m[lane] & tail_mask) != 0);
    if (lane == 0) {
      publish(status + tile, epoch,
              has_start ? kPrefix | (tail_or ? kOrBit : 0u) |
                              static_cast<unsigned>(begin + last_start)
                        : (tail_or ? kOrBit : 0u));
    }
    long long fix_lo = 0, fix_hi = 0, own_hi = 0;
    if (!(s_f[0] & 1u)) {  // row 0 continues a run from the tiles before
      unsigned start;
      bool in_or;
      look_back(status, tile, epoch, &start, &in_or);
      if (!has_start && lane == 0) {
        publish(status + tile, epoch,
                kPrefix | (in_or || tail_or ? kOrBit : 0u) | start);
      }
      // the run ends here: a start follows in the tile, or none does and
      // the tile's last row ends its run
      const int e = rows - 1;
      const bool ends = has_start || ((s_l[e >> 5] >> (e & 31)) & 1u);
      if (ends && (in_or || head_or)) {
        fix_lo = start;
        fix_hi = begin;
      }
      if (ends && in_or) own_hi = first_start;
    }
    if (lane == 0) {
      s_fix[0] = fix_lo;
      s_fix[1] = fix_hi;
      s_fix[2] = own_hi;
    }
  }
  __syncthreads();
  for (long long r = s_fix[0] + tid; r < s_fix[1]; r += kThreads)
    atomicOr(out + r, kSuspect);
  for (long long r = tid; r < s_fix[2]; r += kThreads)
    atomicOr(out + begin + r, kSuspect);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int kRows>
cudaError_t launch(const int* ch, const int* sh, const int* db,
                   const int* perm, const float* positions,
                   const float* cell_size, const float* radius, long long n,
                   int* out, unsigned long long* status, unsigned* counter,
                   unsigned base, unsigned epoch, int tiles,
                   cudaStream_t stream) {
  constexpr int kThreads = kTileRows / kRows;
  if (aligned16(ch) && aligned16(sh) && aligned16(db) && aligned16(perm) &&
      aligned16(out)) {
    mark_pack_kernel<kRows, true><<<tiles, kThreads, 0, stream>>>(
        ch, sh, db, perm, positions, cell_size, radius, n, out, status,
        counter, base, epoch);
  } else {
    mark_pack_kernel<kRows, false><<<tiles, kThreads, 0, stream>>>(
        ch, sh, db, perm, positions, cell_size, radius, n, out, status,
        counter, base, epoch);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t. n in [1, 2^29] (perm must fit below the flag
// bits). ``status`` holds ``capacity`` words, at least ceil(n / 1024), and
// ``counter`` is the tile counter; both belong to this stream alone and
// were zeroed once. ``base`` is the counter's value when this call starts
// (the calls before on the stream added their tile counts to it, mod
// 2^32) and ``epoch`` a tag no earlier call on this scratch used, not 0
// (a zeroed word carries none).
extern "C" int pc_mark_pack(const int* ch, const int* sh, const int* db,
                            const int* perm, const float* positions,
                            const float* cell_size, const float* radius,
                            long long n, int* out, unsigned long long* status,
                            long long capacity, unsigned* counter,
                            unsigned base, unsigned epoch,
                            void* stream_handle) {
  if (n < 1 || n > (1LL << 29) || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  if (tiles > capacity) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const auto run = n <= kFewRows ? launch<2> : launch<4>;
  return static_cast<int>(run(ch, sh, db, perm, positions, cell_size, radius,
                              n, out, status, counter, base, epoch,
                              static_cast<int>(tiles), stream));
}
