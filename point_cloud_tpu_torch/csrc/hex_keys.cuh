// hex_keys.cuh — the dedup pass's per-point arithmetic, shared by B2
// (quantize_hash.cu) and B3 (mark_pack.cu).
//
// Device twins of the port's torch code in core/hex.py (torch_cell_index,
// torch_axial_from_world, torch_axial_to_offset) and ops/dedup.py
// (hex_keys, _mix, _hash_cols), which mirror the reference's
// point_cloud_tpu/core/hex.py:149-201 and ops/dedup.py:168-225.
//
// IEEE f32 lockstep (CLAUDE.md invariant 2): every multiply, add, subtract,
// divide and square root is an explicit _rn intrinsic, in the twins'
// order, so nvcc never contracts a multiply-add into an fma (its default is
// -fmad=true) and every quantization boundary lands where the NumPy, C++
// and torch versions put it. The derived scalars (r*sqrt3, sqrt3/2,
// r*1.5) are rounded to f32 here exactly as the twins round them.
// Integer hashing multiplies in uint32 (i32 wraparound); its right shifts
// are arithmetic, on int32, as torch's ``>>`` on an int32 tensor is.

#pragma once

#include <climits>

namespace pc_hex {

// np.float32(1.73205080757) (core/hex.py SQRT_3): bits 0x3fddb3d7
constexpr float kSqrt3 = 1.73205080757f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Rust ``as i32`` on an integral f32 (torch_saturating_i32): NaN -> 0,
// >= 2^31 -> INT_MAX, <= -2147483904 (the first f32 below INT_MIN) ->
// INT_MIN; every other integral value converts exactly.
__device__ __forceinline__ int sat_i32(float v) {
  if (v != v) return 0;
  if (v >= 2147483648.0f) return INT_MAX;
  if (v <= -2147483904.0f) return INT_MIN;
  return static_cast<int>(v);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

struct Keys {
  int cell[3];  // floor(p / cell_size), saturating
  int sub[3];   // offset hex slot (x, y, z)
  float dist;   // (dx*dx + dy*dy) + dz*dz to the slot centre
};

// torch_cell_index, then torch_axial_from_world + torch_axial_to_offset,
// then the slot centre and distance of ops/dedup.py hex_keys. ``with_dist``
// false skips the centre (B3 needs the keys only).
template <bool with_dist>
__device__ __forceinline__ Keys hex_keys(float px, float py, float pz,
                                         float cell_size, float radius) {
  Keys k;
  k.cell[0] = sat_i32(floorf(dvd(px, cell_size)));
  k.cell[1] = sat_i32(floorf(dvd(py, cell_size)));
  k.cell[2] = sat_i32(floorf(dvd(pz, cell_size)));

  // axial (q, r, h): Charles-Chambers quantization (hex.rs:71-83)
  const float x = dvd(px, mul(radius, kSqrt3));
  const float y = dvd(py, mul(-radius, kSqrt3));
  const float t = add(mul(kSqrt3, y), 1.0f);  // two roundings, no fma
  const float temp1 = floorf(add(t, x));
  const float temp2 = sub(t, x);
  const float temp3 = add(mul(2.0f, x), 1.0f);
  const float qf = dvd(add(temp1, temp3), 3.0f);
  const float rf = dvd(add(temp1, temp2), 3.0f);
  const int q = sat_i32(floorf(qf));
  const int r = static_cast<int>(0u - static_cast<unsigned>(sat_i32(floorf(rf))));
  const int h = sat_i32(truncf(dvd(pz, radius)));  // truncates, not floor

  // axial -> offset: floor division of the even value r - (r & 1) is an
  // arithmetic shift; q + that wraps as i32
  k.sub[0] = wrap_add(q, (r - (r & 1)) >> 1);
  k.sub[1] = r;
  k.sub[2] = h;

  if (with_dist) {
    // slot centre (axial_to_world inlined on the axial indices)
    const float fq = static_cast<float>(q);
    const float fr = static_cast<float>(r);
    const float fh = static_cast<float>(h);
    const float t1 = mul(kSqrt3, fq);
    const float t2 = mul(mul(kSqrt3, 0.5f), fr);  // sqrt3 / 2: exact halving
    const float cx = mul(radius, add(t1, t2));
    const float cy = mul(mul(radius, 1.5f), fr);
    const float cz = mul(fh, radius);
    const float dx = sub(px, cx);
    const float dy = sub(py, cy);
    const float dz = sub(pz, cz);
    k.dist = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
  } else {
    k.dist = 0.0f;
  }
  return k;
}

// _mix: murmur3's final avalanche with i32 wraparound
__device__ __forceinline__ int mix(unsigned h) {
  h ^= static_cast<unsigned>(static_cast<int>(h) >> 16);
  h *= 0x85EBCA6Bu;
  h ^= static_cast<unsigned>(static_cast<int>(h) >> 13);
  h *= 0xC2B2AE35u;
  h ^= static_cast<unsigned>(static_cast<int>(h) >> 16);
  return static_cast<int>(h);
}

// _hash_cols: h = (h + col * p) * 0x9E3779B9 per column, then _mix
__device__ __forceinline__ unsigned hash_step(unsigned h, int col, unsigned p) {
  return (h + static_cast<unsigned>(col) * p) * 0x9E3779B9u;
}

// (cell hash clamped to 0x7FFFFFFE, slot hash) of ops/dedup.py _hash_sort
__device__ __forceinline__ void hashes(const Keys& k, int* cell_hash,
                                       int* slot_hash) {
  unsigned a = 0u;
  a = hash_step(a, k.cell[0], 0x85EBCA6Bu);
  a = hash_step(a, k.cell[1], 0xC2B2AE35u);
  a = hash_step(a, k.cell[2], 0x27D4EB2Fu);
  unsigned b = 0u;
  b = hash_step(b, k.cell[0], 0x165667B1u);
  b = hash_step(b, k.cell[1], 0x9E3779B1u);
  b = hash_step(b, k.cell[2], 0x85EBCA77u);
  b = hash_step(b, k.sub[0], 0xC2B2AE3Du);
  b = hash_step(b, k.sub[1], 0x27D4EB4Fu);
  b = hash_step(b, k.sub[2], 0x94D049BBu);
  *cell_hash = mix(a) & 0x7FFFFFFE;
  *slot_hash = mix(b);
}

}  // namespace pc_hex
