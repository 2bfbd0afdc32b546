// Shared arithmetic of the tile kernels for Hopper (sm_90a): the closest-hit
// kernels closest_hit.cu (every tile staged with plain loads) and
// closest_hit_pipe.cu (tiles staged through two cp.async buffers), and the
// windowed any-hit kernels anyhit.cu and anyhit_pipe.cu built the same two
// ways.  All four run exactly the pair test below, so on the same rays,
// tiles and order the two closest-hit kernels' (t, slot) are bit-equal, the
// two any-hit kernels' bits are equal, and an any-hit bit agrees with the
// closest hit's t on the same ray.
//
// Layout (packed by gpu_pathtracer_tpu_torch/ops/closest_hit.py):
//   rays  (R, 8)            f32  [ox oy oz dx dy dz t_cap t_near], R % 128 == 0;
//                                t_near is the any-hit kernels' and 0 for closest hit
//   tris  (NT, 10, TILE)    f32  rows v1xyz v2xyz v3xyz tol; empty rows are
//                                zero with tol = +inf (det == 0 -> miss)
//   aabb  (NT, 8)           f32  [min xyz, max xyz, 0, 0]; empty tiles inverted
//   order (R / 128, NT)     i32  each block's front-to-back tile order
//
// Arithmetic: built with -fmad=false and without fast math, so the edge
// functions e = a*b - c*d are not contracted into FMAs and the divisions
// (sx, sy, sz, 1/det) are IEEE-rounded; the plain PyTorch versions compute
// the same expressions in the same order.

#pragma once

#include <cuda_runtime.h>

namespace gpt {

constexpr int kBlock = 128;  // rays per block, one thread per ray
constexpr int kWarps = kBlock / 32;
constexpr int kTileRows = 10;
constexpr float kInf = 3.4e38f;
constexpr float kLbSlack = 0.999999f;  // 1 - 1e-6
constexpr unsigned kFull = 0xffffffffu;

// dominant-axis permutation; k = 2 (z dominant), 1 (y), 0 (x); ties go to
// z, then y, as in the TPU kernel's _ray_ctx
__device__ __forceinline__ void permute(int k, float vx, float vy, float vz,
                                        float& x, float& y, float& z) {
  x = (k == 0) ? vy : ((k == 1) ? vz : vx);
  y = (k == 0) ? vz : ((k == 1) ? vx : vy);
  z = (k == 0) ? vx : ((k == 1) ? vy : vz);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One thread's ray with its Woop and slab constants.
struct Ray {
  float ox, oy, oz;
  float t_cap;
  float t_near;                  // the any-hit window's near cap (0 in closest-hit rays)
  int k;                         // dominant axis
  float sx, sy, sz;              // Woop shear
  float inv_dx, inv_dy, inv_dz;  // slab test (1e-20 clamp, sign dropped, as the TPU kernel)
  float dinf;                    // |d|_inf
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ r) {
  Ray q;
  q.ox = r[0];
  q.oy = r[1];
  q.oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  q.t_cap = r[6];
  q.t_near = r[7];
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool is2 = (az >= ax) && (az >= ay);
  const bool is1 = !is2 && (ay >= ax);
  q.k = is2 ? 2 : (is1 ? 1 : 0);
  float pdx, pdy, pdz;
  permute(q.k, dx, dy, dz, pdx, pdy, pdz);
  q.sx = -pdx / pdz;
  q.sy = -pdy / pdz;
  q.sz = 1.0f / pdz;
  q.inv_dx = 1.0f / (ax < 1e-20f ? 1e-20f : dx);
  q.inv_dy = 1.0f / (ay < 1e-20f ? 1e-20f : dy);
  q.inv_dz = 1.0f / (az < 1e-20f ? 1e-20f : dz);
  q.dinf = fmaxf(fmaxf(ax, ay), az);
  return q;
}

// The block's origin box and its max |d|_inf.
struct BlockBox {
  float lo_x, lo_y, lo_z, hi_x, hi_y, hi_z, dmax;
};

// One block-wide reduction; s_box is (7, kWarps) floats of shared memory.
// Ends with every thread holding the same BlockBox.
__device__ __forceinline__ BlockBox block_box(const Ray& q, float (*s_box)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float red[7] = {q.ox, q.oy, q.oz, q.ox, q.oy, q.oz, q.dinf};
  for (int i = 0; i < 3; ++i) red[i] = warp_min(red[i]);
  for (int i = 3; i < 7; ++i) red[i] = warp_max(red[i]);
  if (lane == 0)
    for (int i = 0; i < 7; ++i) s_box[i][warp] = red[i];
  __syncthreads();
  BlockBox b = {s_box[0][0], s_box[1][0], s_box[2][0], s_box[3][0],
                s_box[4][0], s_box[5][0], s_box[6][0]};
  for (int w = 1; w < kWarps; ++w) {
    b.lo_x = fminf(b.lo_x, s_box[0][w]);
    b.lo_y = fminf(b.lo_y, s_box[1][w]);
    b.lo_z = fminf(b.lo_z, s_box[2][w]);
    b.hi_x = fmaxf(b.hi_x, s_box[3][w]);
    b.hi_y = fmaxf(b.hi_y, s_box[4][w]);
    b.hi_z = fmaxf(b.hi_z, s_box[5][w]);
    b.dmax = fmaxf(b.dmax, s_box[6][w]);
  }
  return b;
}

// Chebyshev lower bound from the block's origin box to a tile box (the host
// sorted `order` by the same formula).
__device__ __forceinline__ float tile_lb(const float* __restrict__ b, const BlockBox& bb) {
  return fmaxf(
      fmaxf(fmaxf(b[0] - bb.hi_x, bb.lo_x - b[3]), fmaxf(b[1] - bb.hi_y, bb.lo_y - b[4])),
      fmaxf(fmaxf(b[2] - bb.hi_z, bb.lo_z - b[5]), 0.0f));
}

// Per-ray slab test within the ray's current best t; max(tlo, 0) makes a
// dead ray's budget of -1 (or a padding ray's 0) cull every box.
__device__ __forceinline__ bool slab_hit(const float* __restrict__ b, const Ray& q,
                                         float best_t) {
  const float t0x = (b[0] - q.ox) * q.inv_dx, t1x = (b[3] - q.ox) * q.inv_dx;
  const float t0y = (b[1] - q.oy) * q.inv_dy, t1y = (b[4] - q.oy) * q.inv_dy;
  const float t0z = (b[2] - q.oz) * q.inv_dz, t1z = (b[5] - q.oz) * q.inv_dz;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (thi >= tlo) && (thi > 0.0f) && (fmaxf(tlo, 0.0f) < best_t);
}

// Block max of `v` and block OR of `p` in one pass through shared memory
// (s_best, s_any: kWarps entries each).  Contains one __syncthreads(); the
// caller separates two calls on the same scratch by another barrier.
__device__ __forceinline__ void block_max_any(float v, bool p, float* s_best, int* s_any,
                                              float& block_max, bool& any) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float m = warp_max(v);
  const unsigned vote = __any_sync(kFull, p);
  if (lane == 0) {
    s_best[warp] = m;
    s_any[warp] = (int)vote;
  }
  __syncthreads();
  block_max = s_best[0];
  int a = s_any[0];
  for (int w = 1; w < kWarps; ++w) {
    block_max = fmaxf(block_max, s_best[w]);
    a |= s_any[w];
  }
  any = a != 0;
}

// The watertight Woop test of column `c` of a staged tile (s_tile: (10, tile)
// floats in shared memory) against this thread's ray.  True when the ray's
// line meets the triangle at a t at or above the triangle's tolerance; the
// caller applies its own window (best t, caps) to `t`.
__device__ __forceinline__ bool woop_pair(const float* __restrict__ s_tile, int tile, int c,
                                          const Ray& q, float& t) {
  float x[3], y[3], z[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float vx = s_tile[(3 * v + 0) * tile + c] - q.ox;
    const float vy = s_tile[(3 * v + 1) * tile + c] - q.oy;
    const float vz = s_tile[(3 * v + 2) * tile + c] - q.oz;
    float px, py, pz;
    permute(q.k, vx, vy, vz, px, py, pz);
    x[v] = px + q.sx * pz;
    y[v] = py + q.sy * pz;
    z[v] = pz * q.sz;
  }
  const float e1 = x[1] * y[2] - y[1] * x[2];
  const float e2 = x[2] * y[0] - y[2] * x[0];
  const float e3 = x[0] * y[1] - y[0] * x[1];
  const bool mixed = (e1 < 0.0f || e2 < 0.0f || e3 < 0.0f) &&
                     (e1 > 0.0f || e2 > 0.0f || e3 > 0.0f);
  const float det = e1 + e2 + e3;
  if (mixed || det == 0.0f) return false;
  const float ts = e1 * z[0] + e2 * z[1] + e3 * z[2];
  t = ts * (1.0f / det);
  return t >= s_tile[9 * tile + c];
}

// Every triangle of one staged tile against this thread's ray, in column
// order.  Strict `<` keeps the first triangle at the minimum t within a tile
// and, across tiles, the earlier-visited tile, as the TPU kernel does.
__device__ __forceinline__ void scan_tile(const float* __restrict__ s_tile, int tile, int base,
                                          const Ray& q, float& best_t, int& best_slot) {
  for (int c = 0; c < tile; ++c) {
    float t;
    if (woop_pair(s_tile, tile, c, q, t) && t < best_t && t <= q.t_cap) {
      best_t = t;
      best_slot = base + c;
    }
  }
}

// ---- windowed any-hit (anyhit.cu, anyhit_pipe.cu) --------------------------
// Per ray two bits: far = some accepted hit with t <= t_cap, near = some
// accepted hit with t <= t_cap and t < t_near (strict).  near implies far.

// What is left of a ray's window: nothing (-1) once near is set, [.., t_near)
// once only far is set, else [.., t_cap].  Drives the tile culls only.
__device__ __forceinline__ float anyhit_budget(const Ray& q, bool near, bool far) {
  return near ? -1.0f : (far ? q.t_near : q.t_cap);
}

// One staged tile against this thread's ray.  A ray with nothing left of its
// window (`budget` < 0: near set, a dead or padding ray, or far set and no
// near window) does no pair test, and one that sets near stops there: no
// later triangle can change its bits.
__device__ __forceinline__ void scan_tile_anyhit(const float* __restrict__ s_tile, int tile,
                                                 const Ray& q, float budget, bool& near,
                                                 bool& far) {
  if (budget < 0.0f) return;
  for (int c = 0; c < tile; ++c) {
    float t;
    if (woop_pair(s_tile, tile, c, q, t) && t <= q.t_cap) {
      far = true;
      if (t < q.t_near) {
        near = true;
        return;
      }
    }
  }
}

}  // namespace gpt
