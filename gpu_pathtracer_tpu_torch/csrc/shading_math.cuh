// Float helpers shared by the shading kernels (nee_dense.cu, shade_surface.cu).
//
// Each follows the form the port's torch ops take on the card, so that a
// kernel built with -fmad=false and without fast math rounds as the separate
// aten launches of its plain version do: a sum over a contiguous last axis of
// 3 is (x0 + x2) + x1 (aten's block-x reduction: two lanes, lane 0 holding
// x0 + x2), plus +0 (aten's accumulators start at +0, so a sum of -0s is
// +0); x / c for a Python float c is x * (1 / (float)c); 1.0 / x is
// reciprocal(x) * 1.0; clamp and max propagate NaN.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.141592653589793;  // math.pi
constexpr double kMaxPhongNs = 1.0e6;      // constants.MAX_PHONG_N_S
constexpr float kSmallEps = 1e-5f;         // constants.SMALL_EPS
constexpr float kEps2 = (float)(1e-5 * 1e-5);
constexpr float kTiny = 1e-12f;  // linalg._TINY
constexpr float kInvPi = 1.0f / (float)kPi;
constexpr float kInv2Pi = 1.0f / (float)(2.0 * kPi);
constexpr float kMaxNs = (float)kMaxPhongNs;
constexpr float kMirrorFilter = (float)(kMaxPhongNs / 2.0);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, const long long* s, long long i) {
  const float* q = p + i * s[0];
  return {q[0], q[s[1]], q[2 * s[1]]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 pick3(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.sum over a contiguous last axis of 3
__device__ __forceinline__ float sum_last(V3 a) { return ((a.x + a.z) + a.y) + 0.0f; }
// linalg.dot
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum_last(mul(a, b)); }

// torch.clamp(x, min=lo) and clamp(x, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// linalg.normalize(v, SMALL_EPS)
__device__ __forceinline__ V3 normalize_eps(V3 v) {
  const float n2 = sum_last(mul(v, v));
  const float inv = n2 > kEps2 ? 1.0f / sqrtf(clamp_min(n2, kEps2)) : 0.0f;
  return scale(v, inv);
}

// linalg.safe_pow
__device__ __forceinline__ float safe_pow(float base, float e) {
  const float out = powf(clamp_min(base, kTiny), e);
  const float at_zero = e == 0.0f ? 1.0f : 0.0f;
  return base > kTiny ? out : at_zero;
}

// sampling.n_s_too_large
__device__ __forceinline__ bool mirror_lobe(float n) {
  return fabsf(n - kMaxNs) < kSmallEps || n >= kMaxNs;
}

__device__ __forceinline__ bool same_side(float d1, float d2) {
  return (d1 >= 0.0f && d2 >= 0.0f) || (d1 <= 0.0f && d2 <= 0.0f);
}
__device__ __forceinline__ bool opposite_side(float d1, float d2) {
  return (d1 >= 0.0f && d2 <= 0.0f) || (d1 <= 0.0f && d2 >= 0.0f);
}

}  // namespace
