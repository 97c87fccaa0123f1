// fragments.cu — the fragment emission of the sorted raster (K3), for
// Hopper (sm_90a).
//
// Replaces the reference's emit_fragments, point_cloud_tpu/render/
// splat.py:372-386 (compact_rows then _make_fragments, :187-259), called
// once a footprint class by the renderer's sorted branch (renderer.py:
// 790-821), and the column set-up of sorted_raster_merge (:530-536) and
// _sort4_frags (:567-575). The reference runs them in XLA (no Pallas
// kernel): a compaction, a k x k fragment expansion and four concatenates.
//
// One launch a bucket writes the four columns that sort4 takes, for every
// class of a table in device memory (any number of classes, any window):
// class c draws ``rows[c]`` slots of the ranking's region of class
// ``cls[c]`` (perm[offsets[cls] + i] while i < counts[cls], read from
// device memory; the other slots take row 0 and no valid fragment, as the
// reference's compaction leaves them), each slot through a k[c] x k[c]
// window, slot after slot, class after class.
// Each fragment slot writes
//   pix      the flat pixel index, or _NO_ID (i32::MAX) where invalid;
//   bits     the depth's f32 bits with -0.0 mapped to +0.0, or _NO_ID;
//   id       the row's point id;
//   arrival  the slot's index,
// and the slots past the classes' fragments, up to ``length``, are the
// padding rows (_NO_ID, _NO_ID, 0, index).
//
// The arithmetic is K2's (csrc/splat.cu raster_unit), operation for
// operation: explicit _rn intrinsics (nvcc fuses no multiply-add), rintf
// for odd windows and floorf for even ones, the NaN-propagating max of
// jnp.maximum, __float2int_rz for the pixel. chip_smoke.py holds the
// sorted frame equal to the scatter frame, and this kernel equal to its
// plain twin, bit for bit.
//
// Design: one thread a fragment slot, over a grid-stride loop. The slots
// of a launch fit 2^31 (the arrival index is an i32), so a class's k * k
// and a slot's index within its class fit 32 unsigned bits at any window.
// A thread finds its class by a binary search of the classes' first
// slots (the same entries for most of a warp, from L1), its row and
// window cell by a division, sets its row up (the loads come from L1 or
// L2: a row's k * k slots are neighbours) and writes its four words,
// neighbouring threads on neighbouring words. What
// bounds it: the 16 bytes a slot that it writes (chip_smoke.py
// fragments_bound_ms); the row set-up it repeats for each of a row's
// k * k slots is arithmetic the card has to spare. Simple first: a later
// change may set each row up once and spread its window over a warp, as
// K2 does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNoId = 0x7fffffff;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads) emit_fragments_kernel(
    int* __restrict__ pix, int* __restrict__ bits, int* __restrict__ ids,
    int* __restrict__ arrival, const float* __restrict__ view_pos,
    const float* __restrict__ ndc, const float* __restrict__ radius,
    const int* __restrict__ point_id, const int* __restrict__ perm,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const float* __restrict__ proj, int width, int height, int voronoi,
    const int4* __restrict__ table, int n_classes, long long end,
    long long length) {
  const float p00 = proj[0], p11 = proj[5], p22 = proj[10], p23 = proj[11];
  const float eps = static_cast<float>(1e-6);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < length; g += stride) {
    int out_pix = kNoId, out_bits = kNoId, out_id = 0;
    if (g < end) {
      // the class: the last one whose first slot is at or before g
      int lo = 0, hi = n_classes - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (__ldg(&table[mid].x) <= g) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int4 c = table[lo];
      const int k = c.y;
      const unsigned kk = static_cast<unsigned>(k) * static_cast<unsigned>(k);
      const unsigned local = static_cast<unsigned>(g - c.x);
      const unsigned i = local / kk;  // the class's slot (row)
      const int f = static_cast<int>(local - i * kk);  // the window cell
      const int iy = f / k, ix = f - iy * k;
      const bool row_ok = i < static_cast<unsigned>(max(counts[c.z], 0));
      const long long r =
          row_ok ? perm[static_cast<long long>(offsets[c.z]) + i] : 0;
      out_id = point_id[r];
      if (row_ok) {
        // the row's set-up, as raster_unit does it (csrc/splat.cu)
        const float vz = view_pos[4 * r + 2];
        const float n0 = ndc[3 * r], n1 = ndc[3 * r + 1], n2 = ndc[3 * r + 2];
        const float rad = radius[r];
        const float px =
            mul(add(mul(n0, 0.5f), 0.5f), static_cast<float>(width));
        const float py =
            mul(add(mul(n1, -0.5f), 0.5f), static_cast<float>(height));
        const float w_clip = max_nan(-vz, eps);
        const float rx = max_nan(
            mul(dvd(mul(rad, p00), w_clip), static_cast<float>(0.5 * width)),
            eps);
        const float ry = max_nan(
            mul(dvd(mul(rad, p11), w_clip), static_cast<float>(0.5 * height)),
            eps);
        const int half = (k % 2) ? (k - 1) / 2 : k / 2 - 1;
        const float bx = (k % 2) ? rintf(px) : floorf(px);
        const float by = (k % 2) ? rintf(py) : floorf(py);
        const float fx = add(bx, static_cast<float>(ix - half));
        const float fy = add(by, static_cast<float>(iy - half));
        const float nx = dvd(sub(fx, px), rx);
        const float ny = dvd(sub(fy, py), ry);
        const float d2 = add(mul(nx, nx), mul(ny, ny));
        if (d2 <= 1.0f && fx >= 0.0f && fx < static_cast<float>(width) &&
            fy >= 0.0f && fy < static_cast<float>(height)) {
          float depth = n2;
          if (voronoi) {
            // z_view + radius * (1 - |p|^2), reprojected (splat.py:230-238)
            const float moved_z = add(vz, mul(rad, sub(1.0f, d2)));
            depth = dvd(add(mul(p22, moved_z), p23), -moved_z);
          }
          if (depth >= 0.0f && depth <= 1.0f) {
            out_pix = __float2int_rz(fy) * width + __float2int_rz(fx);
            // -0.0 -> +0.0: the only value in [0, 1] with the sign bit set
            out_bits = static_cast<int>(__float_as_uint(depth) & 0x7fffffffu);
          }
        }
      }
    }
    pix[g] = out_pix;
    bits[g] = out_bits;
    ids[g] = out_id;
    arrival[g] = static_cast<int>(g);
  }
}

}  // namespace

// Writes the four (length,) sort columns of ``n_classes`` classes: ``table``
// is a device array of int4 (first slot, k, cls, rows), one a class, in
// slot order: class c draws rows slots of ranking class cls through a
// k x k window from its first slot on, and the classes' slots end at
// ``end``. The caller keeps rows * k * k summed within ``length``, at most
// 2^31 slots (the arrival index is an i32), every cls below the length of
// counts, and the first slots ascending (render/splat.py builds the
// table). Returns the cudaError_t of the launch.
extern "C" int pc_emit_fragments(int* pix, int* bits, int* ids, int* arrival,
                                 const float* view_pos, const float* ndc,
                                 const float* radius, const int* point_id,
                                 const int* perm, const int* offsets,
                                 const int* counts, const float* proj,
                                 int width, int height, int voronoi,
                                 int n_classes, const int* table,
                                 long long end, long long length,
                                 void* stream) {
  if (width < 1 || height < 1 || n_classes < 1 || end < 0 || end > length ||
      length < 1 || length > (1LL << 31) ||
      static_cast<long long>(width) * height > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long blocks = (length + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  emit_fragments_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pix, bits, ids, arrival, view_pos, ndc, radius, point_id, perm, offsets,
      counts, proj, width, height, voronoi,
      reinterpret_cast<const int4*>(table), n_classes, end, length);
  return static_cast<int>(cudaGetLastError());
}
