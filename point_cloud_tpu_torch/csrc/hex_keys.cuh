// hex_keys.cuh — the dedup pass's per-point arithmetic, shared by B2
// (quantize_hash.cu: the loader of the fused quantize_tile) and B3
// (mark_pack.cu).
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
//
// Division. A row divides by five divisors that are the same for every row
// of a launch: cell_size, r*sqrt3, -r*sqrt3, r and 3. __fdiv_rn refines a
// reciprocal of its divisor on every call (an MUFU.RCP at a quarter of the
// FMA rate, then FMAs, a range check and a branch to its slow path). Here
// a Divisor keeps y = RN(1/b) (__frcp_rn, once a thread or block, outside
// the rows), and a division is the quotient and one correction, with no
// branch:
//   q0 = RN(a * y);  r = RN(a - b * q0) (one fma);  q = RN(q0 + r * y).
// q0 can lie more than an ulp from a / b (RN(1/b)'s error and q0's own
// rounding add up to ~1.5 ulp where b's significand is near 2), so
// Markstein's theorem, which asks for q0 within an ulp, does not cover
// it, and r is then not always exact. q = RN(a / b), the __fdiv_rn
// result, is shown by exhaustion instead: when |a| and |b| lie in
// [2^-60, 2^61), y, q0, r and q are normal, so scaling a or b by a power
// of two scales each of them exactly, and negating either negates them;
// every such division is thus one of the 2^46 with a and b in [1, 2), and
// the card checks all of those against __fdiv_rn (pc_division_sweep in
// quantize_hash.cu; tests/test_torch_front_end.py), as it checks every
// f32 numerator bit pattern over every divisor of MetadataConfig's
// hierarchies 0-7 (pc_division_check; chip_smoke.py phase 3). A zero
// numerator gives q0 = +-0 with the IEEE sign, which is taken as it is.
// Any other numerator (subnormal, near 2^+-126, inf, NaN) clears the
// row's flag, and the row is computed again with __fdiv_rn itself, inside
// the kernel (hex_keys below); a divisor outside the range sends every
// row there. The fmas belong to the division algorithm, as inside
// __fdiv_rn; no multiply-add of the reference's own arithmetic is
// contracted. The CPU tests model the algorithm in exact rational
// arithmetic too.

#pragma once

#include <climits>

namespace pc_hex {

// np.float32(1.73205080757) (core/hex.py SQRT_3): bits 0x3fddb3d7
constexpr float kSqrt3 = 1.73205080757f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The exponents the one-correction quotient takes: biased exponent in
// [kDivLo, kDivLo + kDivSpan), |x| in [2^-60, 2^61).
constexpr unsigned kDivLo = 127 - 60;
constexpr unsigned kDivSpan = 121;

__device__ __forceinline__ bool div_range(float x) {
  return (__float_as_uint(x) & 0x7F800000u) - (kDivLo << 23) <
         (kDivSpan << 23);
}

struct Divisor {
  float b;  // the divisor
  float y;  // RN(1 / b)
};

__device__ __forceinline__ Divisor divisor(float b) {
  return {b, __frcp_rn(b)};
}

// 3 and RN(1/3), for the axial rounding's two divisions
__device__ __forceinline__ Divisor three() {
  return {3.0f, 0x1.555556p-2f};
}

// The divisors of one (cell_size, radius): built once a thread or a block,
// outside the rows. ``fast``: every divisor lies in the quotient's range.
struct Grid {
  float radius;
  Divisor cell;  // cell_size
  Divisor x;     // radius * sqrt3
  Divisor y;     // -radius * sqrt3
  Divisor h;     // radius
  bool fast;
};

__device__ __forceinline__ Grid make_grid(float cell_size, float radius) {
  const float rs = mul(radius, kSqrt3);
  return {radius, divisor(cell_size), divisor(rs), divisor(mul(-radius, kSqrt3)),
          divisor(radius),
          div_range(cell_size) && div_range(rs) && div_range(radius)};
}

// a / d.b as __fdiv_rn computes it
struct IeeeDiv {
  __device__ __forceinline__ float operator()(float a, const Divisor& d) {
    return __fdiv_rn(a, d.b);
  }
};

// The quotient from the divisor's reciprocal, with one correction; ``ok``
// turns false on a numerator it does not take (see the note at the top).
struct FastDiv {
  bool ok;
  __device__ __forceinline__ float operator()(float a, const Divisor& d) {
    ok = ok & (div_range(a) | (a == 0.0f));
    const float q0 = __fmul_rn(a, d.y);
    const float q = __fmaf_rn(__fmaf_rn(-d.b, q0, a), d.y, q0);
    return a == 0.0f ? q0 : q;
  }
};

// Rust ``as i32`` on an integral f32 (torch_saturating_i32): NaN -> 0,
// >= 2^31 -> INT_MAX, <= -2147483904 (the first f32 below INT_MIN) ->
// INT_MIN; every other integral value converts exactly. That is the
// card's own conversion, cvt.rzi.s32.f32 (one F2I): it clamps to the
// destination's range and takes NaN to 0 (the "saturate" and "nonfinite"
// cases of the card tests hold it to the plain version).
__device__ __forceinline__ int sat_i32(float v) { return __float2int_rz(v); }

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
template <bool with_dist, class Div>
__device__ __forceinline__ Keys hex_keys(float px, float py, float pz,
                                         const Grid& g, Div& dvd) {
  Keys k;
  k.cell[0] = sat_i32(floorf(dvd(px, g.cell)));
  k.cell[1] = sat_i32(floorf(dvd(py, g.cell)));
  k.cell[2] = sat_i32(floorf(dvd(pz, g.cell)));

  // axial (q, r, h): Charles-Chambers quantization (hex.rs:71-83)
  const float x = dvd(px, g.x);
  const float y = dvd(py, g.y);
  const float t = add(mul(kSqrt3, y), 1.0f);  // two roundings, no fma
  const float temp1 = floorf(add(t, x));
  const float temp2 = sub(t, x);
  const float temp3 = add(mul(2.0f, x), 1.0f);
  const float qf = dvd(add(temp1, temp3), three());
  const float rf = dvd(add(temp1, temp2), three());
  const int q = sat_i32(floorf(qf));
  const int r = static_cast<int>(0u - static_cast<unsigned>(sat_i32(floorf(rf))));
  const int h = sat_i32(truncf(dvd(pz, g.h)));  // truncates, not floor

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
    const float cx = mul(g.radius, add(t1, t2));
    const float cy = mul(mul(g.radius, 1.5f), fr);
    const float cz = mul(fh, g.radius);
    const float dx = sub(px, cx);
    const float dy = sub(py, cy);
    const float dz = sub(pz, cz);
    k.dist = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
  } else {
    k.dist = 0.0f;
  }
  return k;
}

// hex_keys with FastDiv; the rare row that leaves its range (or a grid
// whose divisors do) again with __fdiv_rn. Bit for bit __fdiv_rn's keys.
template <bool with_dist>
__device__ __forceinline__ Keys hex_keys(float px, float py, float pz,
                                         const Grid& g) {
  FastDiv fast{g.fast};
  const Keys k = hex_keys<with_dist>(px, py, pz, g, fast);
  if (fast.ok) return k;
  IeeeDiv ieee;
  return hex_keys<with_dist>(px, py, pz, g, ieee);
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
