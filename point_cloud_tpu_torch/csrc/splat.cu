// splat.cu — the splat raster of one window rung (K2), for Hopper (sm_90a).
//
// Replaces the reference's per-rung raster, point_cloud_tpu/render/splat.py:
// _make_fragments (:187-259), _rasterize_body (:262-298) and the chunk loop
// _raster_rung_chunked (:614-653). The reference runs them in XLA (no
// Pallas kernel): a k x k fragment expansion, a scatter-min of f32 depth,
// a gather and a masked scatter-min of point ids, looped over fixed-size
// chunks under a lax.while_loop whose trip count is a device value.
//
// One launch rasters one rung: rows perm[start + i] for i < count, where
// start and count are read from device memory, so the host never waits
// for the cull's counts. A grid-stride loop gives one thread per row; the
// thread gathers the row's view_pos.z, ndc, radius and id and walks its
// k x k window: odd k centres on rint(center) (round half to even, as
// jnp.round), even k bases on floor(center). A fragment is kept when it
// lies inside the projected circle, on screen, and at a depth in [0, 1];
// its depth is the point's ndc.z (flat) or the reprojected paraboloid
// (voronoi). The arithmetic is the reference's, in its order, with
// explicit _rn intrinsics so nvcc never fuses a multiply-add.
//
// The depth test is one 64-bit atomicMin on the framebuffer word
// depth_bits << 32 | id: depths are in [0, 1], where the bits order like
// the values, so the minimum word is the nearest fragment and, among equal
// depths, the smallest id: the reference's two scatter-mins in one atomic.
// -0.0 is mapped to +0.0 first (its bits would sort after every positive
// depth). The minimum does not depend on the order of the atomics, so the
// frame is deterministic, and equal to the reference's chunk by chunk.
//
// What bounds it: a thread per row with k*k serial fragments is bound by
// latency and load balance, not bytes: a row reads 28 B (perm entry,
// view_pos.z, ndc, radius, id), and the 64-bit atomics land on a
// framebuffer that the 50 MB L2 holds (7.4 MB at 1280x720), so HBM sees
// each touched word about once (chip_smoke.py raster_bound_ms). A read of
// the word before the atomic skips most losing fragments.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a grid-stride loop covers the rest

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads) splat_raster_kernel(
    unsigned long long* __restrict__ fb, const float* __restrict__ view_pos,
    const float* __restrict__ ndc, const float* __restrict__ radius,
    const int* __restrict__ point_id, const int* __restrict__ perm,
    const int* __restrict__ start_p, const int* __restrict__ count_p,
    const float* __restrict__ proj, int width, int height, int k, int voronoi) {
  const long long start = *start_p;
  const long long count = *count_p;
  const float p00 = proj[0], p11 = proj[5], p22 = proj[10], p23 = proj[11];
  const float eps = static_cast<float>(1e-6);
  const float half_w = static_cast<float>(0.5 * width);
  const float half_h = static_cast<float>(0.5 * height);
  const int half = (k % 2) ? (k - 1) / 2 : k / 2 - 1;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < count; i += stride) {
    const long long r = perm[start + i];
    const float vz = view_pos[4 * r + 2];
    const float n0 = ndc[3 * r], n1 = ndc[3 * r + 1], n2 = ndc[3 * r + 2];
    const float rad = radius[r];
    const unsigned id = static_cast<unsigned>(point_id[r]);

    const float px = mul(add(mul(n0, 0.5f), 0.5f), static_cast<float>(width));
    const float py = mul(add(mul(n1, -0.5f), 0.5f), static_cast<float>(height));
    const float w_clip = max_nan(-vz, eps);
    const float rx = max_nan(mul(dvd(mul(rad, p00), w_clip), half_w), eps);
    const float ry = max_nan(mul(dvd(mul(rad, p11), w_clip), half_h), eps);
    const float bx = (k % 2) ? rintf(px) : floorf(px);
    const float by = (k % 2) ? rintf(py) : floorf(py);

    for (int iy = 0; iy < k; ++iy) {
      const float fy = add(by, static_cast<float>(iy - half));
      const float ny = dvd(sub(fy, py), ry);
      const bool row_on = fy >= 0.0f && fy < static_cast<float>(height);
      for (int ix = 0; ix < k; ++ix) {
        const float fx = add(bx, static_cast<float>(ix - half));
        const float nx = dvd(sub(fx, px), rx);
        const float d2 = add(mul(nx, nx), mul(ny, ny));
        if (!(d2 <= 1.0f) || !row_on || !(fx >= 0.0f) ||
            !(fx < static_cast<float>(width)))
          continue;
        float depth = n2;
        if (voronoi) {
          // z_view + radius * (1 - |p|^2), reprojected (splat.py:230-238)
          const float moved_z = add(vz, mul(rad, sub(1.0f, d2)));
          depth = dvd(add(mul(p22, moved_z), p23), -moved_z);
        }
        if (!(depth >= 0.0f && depth <= 1.0f)) continue;
        unsigned bits = __float_as_uint(depth);
        if (bits == 0x80000000u) bits = 0u;  // -0.0 -> +0.0
        const unsigned long long word =
            (static_cast<unsigned long long>(bits) << 32) | id;
        const long long pix =
            static_cast<long long>(__float2int_rz(fy)) * width + __float2int_rz(fx);
        if (word < fb[pix]) atomicMin(fb + pix, word);
      }
    }
  }
}

}  // namespace

// start and count point to int32 values in device memory; max_rows bounds
// count and sizes the grid. Returns the cudaError_t of the launch.
extern "C" int pc_splat_raster(unsigned long long* fb, const float* view_pos,
                               const float* ndc, const float* radius,
                               const int* point_id, const int* perm,
                               const int* start, const int* count,
                               const float* proj, int width, int height, int k,
                               int voronoi, long long max_rows, void* stream) {
  if (k < 1 || width < 1 || height < 1) return cudaErrorInvalidValue;
  long long blocks = (max_rows + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  splat_raster_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fb, view_pos, ndc, radius, point_id, perm, start, count, proj, width,
      height, k, voronoi);
  return static_cast<int>(cudaGetLastError());
}
