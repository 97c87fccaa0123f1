// splat.cu — the splat raster of one bucket (K2), for Hopper (sm_90a).
//
// Replaces the reference's per-rung raster, point_cloud_tpu/render/splat.py:
// _make_fragments (:187-259), _rasterize_body (:262-298), the chunk loop
// _raster_rung_chunked (:614-653) and the rung loop that calls it
// (:752-785). The reference runs them in XLA (no Pallas kernel): a k x k
// fragment expansion, a scatter-min of f32 depth, a gather and a masked
// scatter-min of point ids, looped over fixed-size chunks under a
// lax.while_loop whose trip count is a device value, once a window rung.
//
// One launch rasters every segment of a bucket. A segment is a run of
// perm rows drawn through one k x k window: a rung's region, capped for
// an overflow rung, or the tail beyond that cap, drawn through the
// footprint window. The table of segments (window, rung, cap, tail flag;
// any number of them, any window) lies in device memory, and so do the
// rungs' counts and offsets, so the host never waits for the cull's
// counts.
//
// Work is cut into units of fragments, not rows. The lanes of a warp lie
// along the columns of the window: a group of k lanes draws one row
// (floor(32 / k) rows a warp at once; one row and one 32-column pass of
// it when k > 32), through a slab of at most 16 window rows, so a 65 x 65
// splat is fifteen units of 13 rows by 32 columns, each spread over a
// whole warp. A unit of a small window holds several such row batches
// (up to 32 rows, near 1024 fragments): every lane first sets one row up
// (its loads, pixel centre and radii: half of a small window's
// instructions when each group did it for itself), and each batch fetches
// its rows' values with shuffles. Warps stride over the unit index space
// (64-bit): the grid is persistent, sized by the occupancy the card
// reports. A warp reads the segment table 32 segments at a time, a lane a
// segment, and forms their units' prefix sum from the device counts with
// shuffles; its units rise, so it reads each chunk of the table once. The
// chunk's unit ends, rows and windows sit in the warp's shared memory, and
// a unit's segment is a ballot over them. A window's tiles
// and a segment's units are 64-bit, so no index overflows at any window.
//
// A lane computes nx for its column once a batch, and ny for one window
// row of the slab; the loop over the slab's rows fetches ny * ny and the
// pixel row with two shuffles. These are the reference's operations on
// the reference's operands, so d2 and everything after it keep their
// bits: odd k centres on rint(center) (round half to even, as jnp.round),
// even k bases on floor(center); a fragment is kept when it lies inside
// the projected circle, on screen, and at a depth in [0, 1]; its depth is
// the point's ndc.z (flat) or the reprojected paraboloid (voronoi); every
// operation is an explicit _rn intrinsic, so nvcc fuses no multiply-add.
//
// The depth test is one 64-bit atomicMin on the framebuffer word
// depth_bits << 32 | id: depths are in [0, 1], where the bits order like
// the values, so the minimum word is the nearest fragment and, among equal
// depths, the smallest id: the reference's two scatter-mins in one atomic.
// -0.0 is mapped to +0.0 first (its bits would sort after every positive
// depth). A minimum does not depend on the order of segments, rows or
// fragments, so the frame is deterministic and equal to the reference's.
// A read of the word before the atomic skips the losing fragments; a
// stale read is safe (the word only falls: at worst a needless atomic).
//
// What bounds it: instruction slots and the atomics, not bytes. A row
// reads 28 B and the plane (7.4 MB at 1280x720) lives in the 50 MB L2, so
// HBM sees each touched word about once (chip_smoke.py raster_bound_ms);
// the lanes of a group touch neighbouring words, so a window row is one
// or two 32-byte sectors. There is no tile to stage and no matrix product: TMA
// and wgmma have no work here. What the card gives this kernel is
// occupancy, L2 residency and warp shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks a SM: 48 registers a thread. At 6 and 40 registers the warps'
// table state pushed spills into the raster's loop, 10% slower than the
// by-value table of 32 segments on the orbit's largest bucket; at 5, 1-4%
// (tools/kernel_ab.py frame, H100 80GB HBM3 at 700 W)
constexpr int kMinBlocks = 5;
constexpr int kSlabRows = 16;    // most window rows a unit
constexpr int kUnitFragments = 1024;  // a unit's size where rows allow
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

struct Frame {
  unsigned long long* fb;
  const float* view_pos;
  const float* ndc;
  const float* radius;
  const int* point_id;
  float p00, p11, p22, p23;
  int width, height, voronoi;
};

// The shape of a segment's units, from its window alone.
struct Shape {
  int k;
  int group;        // lanes a row: min(k, 32)
  int rpw;          // rows a warp draws at once: 32 / group
  int batches;      // such row batches a unit
  int passes;       // 32-column passes of the window
  long long tiles;  // slabs x passes
  int slab_rows;    // window rows a slab
};

__device__ __forceinline__ Shape shape_of(int k) {
  Shape s;
  s.k = k;
  s.group = k <= 32 ? k : 32;
  s.rpw = 32 / s.group;
  // a unit sets up to 32 rows up at once, one a lane, as long as it stays
  // near kUnitFragments: small windows share the set-up, large ones keep
  // many units (a window wider than 32 holds more than kUnitFragments)
  s.batches = k > 32 ? 1
                     : max(1, min(32 / s.rpw, kUnitFragments / (s.rpw * k * k)));
  s.passes = (k - 1) / 32 + 1;
  const int slabs = (k - 1) / kSlabRows + 1;
  s.tiles = static_cast<long long>(slabs) * s.passes;
  s.slab_rows = (k - 1) / slabs + 1;
  return s;
}

// A segment's rows: its first row in perm, its row count and its window.
// The table holds a segment as one int4: x the window k, y the rung (an
// index into counts and offsets), z the cap (rows the rung draws through
// its own window), w the tail flag (1: the rows beyond cap; 0: the rows
// up to it).
struct SegmentRows {
  long long start, count;
  int k;
};

__device__ __forceinline__ SegmentRows segment_rows(
    const int4* __restrict__ table, const int* __restrict__ offsets,
    const int* __restrict__ counts, long long s) {
  const int4 seg = table[s];
  const long long cap = seg.z;
  const long long c = counts[seg.y];
  SegmentRows r;
  r.start = offsets[seg.y];
  if (seg.w) {
    r.start += cap;
    r.count = c > cap ? c - cap : 0;
  } else {
    r.count = c < cap ? (c > 0 ? c : 0) : cap;
  }
  r.k = seg.x;
  return r;
}

// One unit: rows [first_row, first_row + rpw * batches) of the segment
// ``rows`` (count of them), window rows [slab * slab_rows, ...) and window
// columns [32 * pass, ...) of the k x k window. Every lane first sets up
// one row of the unit; then the warp draws rpw rows at a time, a lane
// fetching the row of its group (``sub_row``) with shuffles and taking the
// window column ``col``; lanes with sub_row >= rpw draw nothing.
__device__ __forceinline__ void raster_unit(
    const Frame& f, const int* __restrict__ rows, long long count,
    long long first_row, int slab, int pass, const Shape& sh, int sub_row,
    int col) {
  const int k = sh.k;
  const int lane = threadIdx.x % 32;
  const int half = (k % 2) ? (k - 1) / 2 : k / 2 - 1;
  const long long left = count - first_row;  // >= 1 rows from first_row on
  // this lane's row (a valid one to load even where the unit has none for
  // it). Every lane sets a row up, though a large window's unit draws one:
  // leaving the idle lanes out measured 1% slower on a frame's bucket and
  // no faster on 33- and 65-px windows
  const long long r = rows[first_row + (lane < left ? lane : left - 1)];
  const float my_vz = f.view_pos[4 * r + 2];
  const float n0 = f.ndc[3 * r], n1 = f.ndc[3 * r + 1];
  const float my_n2 = f.ndc[3 * r + 2];
  const float my_rad = f.radius[r];
  const unsigned my_id = static_cast<unsigned>(f.point_id[r]);
  const float eps = static_cast<float>(1e-6);
  const float my_px =
      mul(add(mul(n0, 0.5f), 0.5f), static_cast<float>(f.width));
  const float my_py =
      mul(add(mul(n1, -0.5f), 0.5f), static_cast<float>(f.height));
  const float w_clip = max_nan(-my_vz, eps);
  const float my_rx = max_nan(
      mul(dvd(mul(my_rad, f.p00), w_clip), static_cast<float>(0.5 * f.width)),
      eps);
  const float my_ry = max_nan(
      mul(dvd(mul(my_rad, f.p11), w_clip), static_cast<float>(0.5 * f.height)),
      eps);

  const int ix = col + 32 * pass;
  const int iy0 = slab * sh.slab_rows;
  const int iy = iy0 + col;
  const int steps = min(sh.slab_rows, k - iy0);
  const int first = sub_row * sh.group;  // the lane with the group's row 0
  for (int b = 0; b < sh.batches; ++b) {
    const int src = b * sh.rpw + sub_row;  // the lane that set my row up
    if (b * sh.rpw >= left) break;         // the segment ends in this unit
    const bool live = sub_row < sh.rpw && src < left;
    const float px = __shfl_sync(kAll, my_px, src);
    const float py = __shfl_sync(kAll, my_py, src);
    const float rx = __shfl_sync(kAll, my_rx, src);
    const float ry = __shfl_sync(kAll, my_ry, src);
    const float vz = __shfl_sync(kAll, my_vz, src);
    const float rad = __shfl_sync(kAll, my_rad, src);
    const float n2 = __shfl_sync(kAll, my_n2, src);
    const unsigned id = __shfl_sync(kAll, my_id, src);
    const float bx = (k % 2) ? rintf(px) : floorf(px);
    const float by = (k % 2) ? rintf(py) : floorf(py);

    // this lane's column: nx * nx and the pixel column, -1 when off
    const float fx = add(bx, static_cast<float>(ix - half));
    const float nx = dvd(sub(fx, px), rx);
    const float nx2 = mul(nx, nx);
    const bool col_on = live && ix < k && fx >= 0.0f &&
                        fx < static_cast<float>(f.width);
    const int x = col_on ? __float2int_rz(fx) : -1;
    // this lane's window row of the slab: ny * ny and the pixel row's
    // first word in the plane, -1 when off
    const float fy = add(by, static_cast<float>(iy - half));
    const float ny = dvd(sub(fy, py), ry);
    const float my_ny2 = mul(ny, ny);
    const bool row_on = col < sh.slab_rows && iy < k && fy >= 0.0f &&
                        fy < static_cast<float>(f.height);
    const int my_y = row_on ? __float2int_rz(fy) * f.width : -1;

    for (int s = 0; s < steps; ++s) {
      const float ny2 = __shfl_sync(kAll, my_ny2, first + s);
      const int y = __shfl_sync(kAll, my_y, first + s);
      const float d2 = add(nx2, ny2);
      if (d2 <= 1.0f && (x | y) >= 0) {
        float depth = n2;
        if (f.voronoi) {
          // z_view + radius * (1 - |p|^2), reprojected (splat.py:230-238)
          const float moved_z = add(vz, mul(rad, sub(1.0f, d2)));
          depth = dvd(add(mul(f.p22, moved_z), f.p23), -moved_z);
        }
        if (depth >= 0.0f && depth <= 1.0f) {
          // -0.0 -> +0.0: the only value in [0, 1] with the sign bit set
          const unsigned bits = __float_as_uint(depth) & 0x7fffffffu;
          const unsigned long long word =
              (static_cast<unsigned long long>(bits) << 32) | id;
          unsigned long long* at = f.fb + (y + x);
          if (word < *at) atomicMin(at, word);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) splat_raster_kernel(
    unsigned long long* __restrict__ fb, const float* __restrict__ view_pos,
    const float* __restrict__ ndc, const float* __restrict__ radius,
    const int* __restrict__ point_id, const int* __restrict__ perm,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const float* __restrict__ proj, int width, int height, int voronoi,
    const int4* __restrict__ table, int n_segments) {
  // per warp, the chunk of 32 segments it has reached: ends[0] is where
  // the chunk's units begin and ends[l + 1] where segment 32 * chunk + l's
  // units end (counted from unit 0 of the launch); start, count and k are
  // that segment's first row in perm, its rows and its window. Shared
  // memory: a unit reads its segment's rows there, as the raster's loop
  // needs every register
  constexpr int kWarps = kThreads / 32;
  __shared__ long long s_ends[kWarps][33];
  __shared__ long long s_start[kWarps][32], s_count[kWarps][32];
  __shared__ int s_k[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  long long* ends = s_ends[warp];
  if (lane == 0) ends[32] = 0;
  __syncwarp();
  Frame f;
  f.fb = fb;
  f.view_pos = view_pos;
  f.ndc = ndc;
  f.radius = radius;
  f.point_id = point_id;
  f.p00 = proj[0];
  f.p11 = proj[5];
  f.p22 = proj[10];
  f.p23 = proj[11];
  f.width = width;
  f.height = height;
  f.voronoi = voronoi;

  int chunk = -1;
  int j = -1;  // the lane in the chunk whose segment the last unit drew
  Shape sh = shape_of(1);
  int sub_row = 0, col = 0;
  long long base = 0;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + warp;;
       u += static_cast<long long>(gridDim.x) * kWarps) {
    while (u >= ends[32]) {  // the warp moves on to the next chunk
      if (32 * (chunk + 1) >= n_segments) return;  // past the last unit
      const long long carry = ends[32];
      ++chunk;
      const int s = 32 * chunk + lane;
      long long units = 0;
      SegmentRows r{0, 0, 1};
      if (s < n_segments) {
        r = segment_rows(table, offsets, counts, s);
        const Shape ss = shape_of(r.k);
        const int unit_rows = ss.rpw * ss.batches;
        units = (r.count + unit_rows - 1) / unit_rows * ss.tiles;
      }
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const long long below = __shfl_up_sync(kAll, units, d);
        if (lane >= d) units += below;
      }
      __syncwarp();  // every lane has read the old chunk's end
      if (lane == 0) ends[0] = carry;
      ends[lane + 1] = carry + units;
      s_start[warp][lane] = r.start;
      s_count[warp][lane] = r.count;
      s_k[warp][lane] = r.k;
      __syncwarp();
      j = -1;
    }
    // the unit's segment: the first lane of the chunk whose units end past u
    const int jl = __popc(__ballot_sync(kAll, ends[lane + 1] <= u));
    if (jl != j) {
      j = jl;
      base = ends[jl];
      sh = shape_of(s_k[warp][jl]);
      sub_row = lane / sh.group;
      col = lane - sub_row * sh.group;
    }
    const long long local = u - base;
    long long batch = local;  // a window of one tile needs no division
    int slab = 0, pass = 0;
    if (sh.tiles > 1) {
      batch = local / sh.tiles;
      const long long tile = local - batch * sh.tiles;
      const long long slab64 = tile / sh.passes;
      slab = static_cast<int>(slab64);
      pass = static_cast<int>(tile - slab64 * sh.passes);
    }
    raster_unit(f, perm + s_start[warp][j], s_count[warp][j],
                batch * (sh.rpw * sh.batches), slab, pass, sh, sub_row, col);
  }
}

}  // namespace

// Rasters the ``n_segments`` segments of ``table`` in one launch: a
// device array of int4 (k, rung, cap, tail), one a segment. Segment s
// draws rows of perm through a k x k window (k >= 1), from its rung's
// region [offsets[r], offsets[r] + counts[r]) of device memory: its first
// min(count, cap) rows (cap >= 0), or with tail the rows beyond cap. The
// caller keeps every rung below the length of counts and every segment's
// units (rows over a unit's rows, times the window's tiles) in 64 bits
// (render/splat.py checks both). Returns the cudaError_t of the launch.
extern "C" int pc_splat_raster(unsigned long long* fb, const float* view_pos,
                               const float* ndc, const float* radius,
                               const int* point_id, const int* perm,
                               const int* offsets, const int* counts,
                               const float* proj, int width, int height,
                               int voronoi, int n_segments, const int* table,
                               void* stream) {
  if (width < 1 || height < 1 || n_segments < 1 ||
      static_cast<long long>(width) * height > 0x7fffffffLL)  // int pixel index
    return cudaErrorInvalidValue;
  // a full persistent grid on the current device
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, splat_raster_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  splat_raster_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fb, view_pos, ndc, radius, point_id, perm, offsets, counts, proj, width,
      height, voronoi, reinterpret_cast<const int4*>(table), n_segments);
  return static_cast<int>(cudaGetLastError());
}
