// The closest-hit query's dispatch around the tile kernel, one thread a ray:
// what query_key.cu, query_pack.cu and query_finish.cu share.
//
// Replaces no TPU kernel: the JAX package and the port's plain version
// (`gpu_pathtracer_tpu_torch.ops.trace.closest_hit_reference`) run these steps
// as torch ops: `park_dead`, `coherence_perm`, `closest_hit.prepare_rays`
// (`root_exit_cap`), the inverse permutation's gathers and `winner_bary`
// (`intersect.intersect_tris` on the winning triangle).  Each function below
// follows one of them with the same arithmetic.
//
// Arithmetic: built with -fmad=false and without fast math, so each
// expression rounds as the separate aten launches of the plain version do on
// the card.  Forms of torch's kernels followed here: a / b of two tensors is a
// true division and 1.0 / x is reciprocal(x) * 1.0; x * c and x + c for a
// Python float c use (float)c; torch.minimum, torch.maximum, amin, amax and
// clamp propagate NaN; argmax picks the first maximum, NaN first; a float to
// int64 cast is C++'s, as aten's copy kernel makes it.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTinyDir = (float)1e-20;   // root_exit_cap's |d| floor
constexpr float kExitScale = (float)1.0001;
constexpr float kExitPad = (float)1e-4;
constexpr float kCapMax = (float)3.4e38;   // closest_hit._INF
constexpr float kSplit = (float)4097.0;    // intersect._SPLIT
constexpr int kDeadKey = 1 << 21;          // a dead ray's key bit (coherence_perm)

// `trace.root_box`: (3, 3) float32 rows, the root box's low corner (min of
// the tile boxes' low corners), its span clamp(max of the high corners - lo,
// 1e-12), and its high corner over the non-empty tile boxes
struct Root {
  float lo[3], span[3], hi[3];
};

__device__ __forceinline__ Root load_root(const float* t) {
  Root r;
  for (int c = 0; c < 3; ++c) {
    r.lo[c] = t[c];
    r.span[c] = t[3 + c];
    r.hi[c] = t[6 + c];
  }
  return r;
}

struct Ray {
  float o[3], d[3];
};

// ray j of the caller's (R, 3) origins and directions (strides in elements),
// parked as `trace.park_dead` parks a dead ray: at the root box's low corner,
// along +z; `live` null: every ray live
__device__ __forceinline__ Ray load_ray(const float* o, const long long* os, const float* d,
                                        const long long* ds, const unsigned char* live,
                                        long long live_s, long long j, const Root& root,
                                        bool* alive) {
  Ray r;
  *alive = live == nullptr || live[j * live_s] != 0;
  for (int c = 0; c < 3; ++c) {
    r.o[c] = *alive ? o[j * os[0] + c * os[1]] : root.lo[c];
    r.d[c] = *alive ? d[j * ds[0] + c * ds[1]] : (c == 2 ? 1.0f : 0.0f);
  }
  return r;
}

// torch.minimum / torch.maximum (and amin / amax): NaN propagates
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
// torch.clamp(x, lo, hi): NaN passes through
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// morton.expand_bits on int64 (wrapping products, as aten's)
__device__ __forceinline__ unsigned long long expand_bits(unsigned long long v) {
  v = (v * 0x00010001ull) & 0xFF0000FFull;
  v = (v * 0x00000101ull) & 0x0F00F00Full;
  v = (v * 0x00000011ull) & 0xC30C30C3ull;
  v = (v * 0x00000005ull) & 0x49249249ull;
  return v;
}

// `coherence_perm`'s key of a (parked) ray: (morton << 3) | octant, the dead
// bit apart; below 2^22 for every float origin
__device__ __forceinline__ int coherence_key(const Ray& r, const Root& root, bool alive) {
  const unsigned long long octant =
      (r.d[0] > 0.0f ? 4ull : 0ull) + (r.d[1] > 0.0f ? 2ull : 0ull) + (r.d[2] > 0.0f ? 1ull : 0ull);
  unsigned long long e[3];
  for (int c = 0; c < 3; ++c) {
    const float q = nan_clamp((r.o[c] - root.lo[c]) / root.span[c] * 64.0f, 0.0f, 63.0f);
    e[c] = expand_bits((unsigned long long)(long long)q);
  }
  const unsigned long long m = e[0] * 4ull + e[1] * 2ull + e[2];
  unsigned long long key = (m << 3) | octant;
  if (!alive) key |= (unsigned long long)kDeadKey;
  return (int)(long long)key;
}

// `closest_hit.root_exit_cap` of one ray with its budget, then prepare_rays'
// clamp at closest_hit._INF
__device__ __forceinline__ float root_exit_cap(const Ray& r, const Root& root, float t_max) {
  float exit_t = 0.0f, entry_t = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float d = fabsf(r.d[c]) < kTinyDir ? kTinyDir : r.d[c];
    const float inv = 1.0f / d;
    const float ta = (root.lo[c] - r.o[c]) * inv;
    const float tb = (root.hi[c] - r.o[c]) * inv;
    const float far_t = nan_max(ta, tb), near_t = nan_min(ta, tb);
    exit_t = c == 0 ? far_t : nan_min(exit_t, far_t);
    entry_t = c == 0 ? near_t : nan_max(entry_t, near_t);
  }
  const bool hits_root = exit_t >= entry_t && exit_t > 0.0f;
  const float cap = hits_root ? nan_min(t_max, exit_t * kExitScale + kExitPad) : -1.0f;
  return isnan(cap) ? cap : fminf(cap, kCapMax);
}

// intersect._two_product and _diff_of_products_exact: a*b - c*d compensated
__device__ __forceinline__ void two_product(float a, float b, float* p, float* err) {
  *p = a * b;
  const float a1 = a * kSplit;
  const float a_hi = a1 - (a1 - a);
  const float a_lo = a - a_hi;
  const float b1 = b * kSplit;
  const float b_hi = b1 - (b1 - b);
  const float b_lo = b - b_hi;
  *err = (((a_hi * b_hi - *p) + a_hi * b_lo) + a_lo * b_hi) + a_lo * b_lo;
}

__device__ __forceinline__ float diff_of_products_exact(float a, float b, float c, float d) {
  float p1, e1, p2, e2;
  two_product(a, b, &p1, &e1);
  two_product(c, d, &p2, &e2);
  return (p1 - p2) + (e1 - e2);
}

// intersect._permute3: components under kx = (kz+1)%3, ky = (kz+2)%3
__device__ __forceinline__ void permute3(const float* v, int kz, float* x, float* y, float* z) {
  *x = kz == 0 ? v[1] : (kz == 1 ? v[2] : v[0]);
  *y = kz == 0 ? v[2] : (kz == 1 ? v[0] : v[1]);
  *z = kz == 0 ? v[0] : (kz == 1 ? v[1] : v[2]);
}

// `winner_bary`'s barycentrics of one ray against its winning triangle
// (vertices tri[0..8] as the attr row's columns 0:9): intersect_tris with
// K = 1, the edge functions' Dekker fallback where one is exactly 0
__device__ __forceinline__ void winner_bary(const Ray& r, const float* tri, float* bary) {
  // argmax |d|, x first on ties, the first NaN before any number
  int kz = 0;
  float best = fabsf(r.d[0]);
  for (int k = 1; k < 3; ++k) {
    const float v = fabsf(r.d[k]);
    if (!isnan(best) && (isnan(v) || v > best)) {
      best = v;
      kz = k;
    }
  }
  float dx, dy, dz;
  permute3(r.d, kz, &dx, &dy, &dz);
  const float sx = -dx / dz;
  const float sy = -dy / dz;
  float x[3], y[3];
  for (int v = 0; v < 3; ++v) {
    const float pt[3] = {tri[3 * v] - r.o[0], tri[3 * v + 1] - r.o[1], tri[3 * v + 2] - r.o[2]};
    float px, py, pz;
    permute3(pt, kz, &px, &py, &pz);
    x[v] = px + sx * pz;
    y[v] = py + sy * pz;
  }
  float e1 = x[1] * y[2] - y[1] * x[2];
  float e2 = x[2] * y[0] - y[2] * x[0];
  float e3 = x[0] * y[1] - y[0] * x[1];
  if (e1 == 0.0f || e2 == 0.0f || e3 == 0.0f) {
    e1 = diff_of_products_exact(x[1], y[2], y[1], x[2]);
    e2 = diff_of_products_exact(x[2], y[0], y[2], x[0]);
    e3 = diff_of_products_exact(x[0], y[1], y[0], x[1]);
  }
  const float det = (e1 + e2) + e3;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  bary[0] = e1 * inv_det;
  bary[1] = e2 * inv_det;
  bary[2] = e3 * inv_det;
}

}  // namespace
