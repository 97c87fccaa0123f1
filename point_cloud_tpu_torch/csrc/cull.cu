// cull.cu — the frame's fused cull and footprint classification (K1), for
// Hopper (sm_90a).
//
// Replaces the camera half of the reference's frame kernel,
// point_cloud_tpu/render/kernel.py _cull_body (:205-346), together with the
// window-ladder classification of the chunked bucket pass,
// render/splat.py:729-750. The reference computes both in XLA (no Pallas
// kernel); eagerly in PyTorch they are ~60 small elementwise ops a bucket.
//
// One thread per point, no shared state between points:
//   view_pos = (x, y, z, 1) . view^T, clip = view_pos . projection^T,
//   ndc = clip.xyz / clip.w, inside = |ndc.x|, |ndc.y| <= 1, |ndc.z - .5| <= .5;
//   the distance override (size_by_distance), the per-hierarchy radius;
//   with a depth plane, the centre-sample occlusion test, and with a coarse
//   grid, the depth-pyramid gate; then rmax = max(rx, ry) in pixels and the
//   point's exclusive rung: the first ladder rung j < R - 1 whose
//   threshold k_j / 2 exceeds rmax, else the catch-all R - 1 (a NaN rmax
//   fits none); -1 where the point is not kept. A ladder has any number
//   of rungs (a footprint F gives F - 1 sub-rungs): the scan reads the
//   thresholds from device memory through the read-only cache (the lanes
//   of a warp read the same few, one L1 broadcast a compare) and stops at
//   the first fit, so a point costs as many compares as its rung's index.
//
// Arithmetic is IEEE single precision in the reference's order, with every
// multiply, add and divide an explicit _rn intrinsic so nvcc never contracts
// a multiply-add into an fma. The 4-term dot products are summed pairwise,
// (p0 + p1) + (p2 + p3): the order of XLA:CPU's (N,4)x(4,4) product, which
// the plain PyTorch twin (render/kernel.py cull_classify_reference) writes
// out the same way. Float-to-int casts use __float2int_rz (truncation that
// saturates; NaN gives 0), so a point near the eye plane never forms a wild
// gather index; such points fail the NDC test and are not kept anyway.
//
// What bounds it: bytes. A point reads 17 B (position, hierarchy, valid)
// plus two 4 B gathers (depth, coarse grid) and writes 45 B (keep,
// hierarchy, view_pos, ndc, radius, rmax, rung). The bucket pass reads
// 37 B of those outputs (not hierarchy or rmax), so the least it must move
// is ~54 B a point plus the depth reads: ~18 us at 2^20 points at 3.35
// TB/s (chip_smoke.py cull_bound_ms). The per-frame constants sit in
// shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHierarchies = 24;  // render/kernel.py MAX_HIERARCHIES
constexpr int kPyramidTile = 8;  // render/kernel.py PYRAMID_TILE

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// jnp.maximum / torch.maximum: NaN in either operand propagates (fmaxf
// would return the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// row j of m (row-major 4x4) against (a0, a1, a2, a3), summed pairwise
__device__ __forceinline__ float dot4(const float* m, int j, float a0, float a1,
                                      float a2, float a3) {
  return add(add(mul(a0, m[4 * j]), mul(a1, m[4 * j + 1])),
             add(mul(a2, m[4 * j + 2]), mul(a3, m[4 * j + 3])));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) cull_classify_kernel(
    const float* __restrict__ positions, const int* __restrict__ hier_base,
    const unsigned char* __restrict__ valid, const float* __restrict__ view,
    const float* __restrict__ proj, const float* __restrict__ cam_pos,
    const float* __restrict__ spacings, const float* __restrict__ far_distances,
    int size_by_distance, int max_hierarchy, const float* __restrict__ depth,
    const float* __restrict__ coarse, int coarse_w,
    const float* __restrict__ thresholds, int n_rungs, int width, int height,
    unsigned char* __restrict__ keep_out, int* __restrict__ hierarchy_out,
    float* __restrict__ view_pos_out, float* __restrict__ ndc_out,
    float* __restrict__ radius_out, float* __restrict__ rmax_out,
    int* __restrict__ rung_out, long long n) {
  __shared__ float s_view[16], s_proj[16], s_cam[3];
  __shared__ float s_spacing[kMaxHierarchies], s_far[kMaxHierarchies];
  const int t = threadIdx.x;
  if (t < 16) {
    s_view[t] = view[t];
    s_proj[t] = proj[t];
  }
  if (t < 3) s_cam[t] = cam_pos[t];
  if (t < kMaxHierarchies) {
    s_spacing[t] = spacings[t];
    s_far[t] = far_distances[t];
  }
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
  if (i >= n) return;
  const float x = positions[3 * i], y = positions[3 * i + 1],
              z = positions[3 * i + 2];

  float vp[4], clip[4];
  for (int j = 0; j < 4; ++j) vp[j] = dot4(s_view, j, x, y, z, 1.0f);
  for (int j = 0; j < 4; ++j) clip[j] = dot4(s_proj, j, vp[0], vp[1], vp[2], vp[3]);
  const float nx = dvd(clip[0], clip[3]), ny = dvd(clip[1], clip[3]),
              nz = dvd(clip[2], clip[3]);
  bool keep = fabsf(nx) <= 1.0f && fabsf(ny) <= 1.0f &&
              fabsf(sub(nz, 0.5f)) <= 0.5f && valid[i] != 0;

  // distance override (kernel.py:230-243): the largest hierarchy h with
  // base < h <= max_hierarchy whose far distance exceeds the camera's
  const int base = hier_base[i];
  const float dx = sub(x, s_cam[0]), dy = sub(y, s_cam[1]), dz = sub(z, s_cam[2]);
  const float dist = __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
  int over = -1;
  for (int h = 0; h < kMaxHierarchies; ++h) {
    if (h > base && h <= max_hierarchy && dist < s_far[h]) over = h;
  }
  const int hier = (size_by_distance && over >= 0) ? over : base;
  const float radius =
      (hier >= 0 && hier < kMaxHierarchies) ? s_spacing[hier] : 0.0f;

  // projected half-extents in pixels (splat.py splat_pixel_radii)
  const float w_clip = max_nan(-vp[2], static_cast<float>(1e-6));
  const float eps = static_cast<float>(1e-6);
  const float rx = max_nan(
      mul(dvd(mul(radius, s_proj[0]), w_clip), static_cast<float>(0.5 * width)), eps);
  const float ry = max_nan(
      mul(dvd(mul(radius, s_proj[5]), w_clip), static_cast<float>(0.5 * height)), eps);
  const float rmax = max_nan(rx, ry);

  if (depth != nullptr) {  // occlusion (kernel.py:259-283)
    const float u = mul(add(mul(nx, 0.5f), 0.5f), static_cast<float>(width));
    const float v = mul(add(mul(ny, -0.5f), 0.5f), static_cast<float>(height));
    const int ui = clampi(__float2int_rz(u), 0, width - 1);
    const int vi = clampi(__float2int_rz(v), 0, height - 1);
    const float depth_at = depth[static_cast<long long>(vi) * width + ui];
    const float mv2 = add(vp[2], radius);
    const float mc2 = dot4(s_proj, 2, vp[0], vp[1], mv2, vp[3]);
    const float mc3 = dot4(s_proj, 3, vp[0], vp[1], mv2, vp[3]);
    const float moved_z = dvd(mc2, mc3);
    const float radius_z = sub(nz, moved_z);
    keep = keep && ((moved_z < depth_at) ||
                    (sub(moved_z, depth_at) < mul(radius_z, 3.0f)));
    if (coarse != nullptr) {  // depth-pyramid gate (kernel.py:304-344)
      const float coarse_at =
          coarse[static_cast<long long>(vi / kPyramidTile) * coarse_w +
                 ui / kPyramidTile];
      const bool in_front = add(vp[2], radius) < 0.0f;
      const bool reject = in_front &&
                          rmax <= static_cast<float>(kPyramidTile - 1) &&
                          moved_z > coarse_at;
      keep = keep && !reject;
    }
  }

  int rung = -1;
  if (keep) {
    rung = n_rungs - 1;
    for (int j = 0; j < n_rungs - 1; ++j) {
      if (rmax < __ldg(thresholds + j)) {
        rung = j;
        break;
      }
    }
  }

  keep_out[i] = keep ? 1 : 0;
  hierarchy_out[i] = hier;
  reinterpret_cast<float4*>(view_pos_out)[i] = make_float4(vp[0], vp[1], vp[2], vp[3]);
  ndc_out[3 * i] = nx;
  ndc_out[3 * i + 1] = ny;
  ndc_out[3 * i + 2] = nz;
  radius_out[i] = radius;
  rmax_out[i] = rmax;
  rung_out[i] = rung;
}

}  // namespace

// depth and coarse are null when occlusion / the pyramid gate are off.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pc_cull_classify(
    const float* positions, const int* hier_base, const unsigned char* valid,
    const float* view, const float* proj, const float* cam_pos,
    const float* spacings, const float* far_distances, int size_by_distance,
    int max_hierarchy, const float* depth, const float* coarse, int coarse_w,
    const float* thresholds, int n_rungs, int width, int height,
    unsigned char* keep, int* hierarchy, float* view_pos, float* ndc,
    float* radius, float* rmax, int* rung, long long n, void* stream) {
  if (n_rungs < 1) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  cull_classify_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      positions, hier_base, valid, view, proj, cam_pos, spacings, far_distances,
      size_by_distance, max_hierarchy, depth, coarse, coarse_w, thresholds,
      n_rungs, width, height, keep, hierarchy, view_pos, ndc, radius, rmax, rung,
      n);
  return static_cast<int>(cudaGetLastError());
}
