// Shared arithmetic and walk of the tile kernels for Hopper (sm_90a): the
// closest-hit kernels closest_hit.cu (candidate tiles staged with plain
// loads), closest_hit_pipe.cu (candidate tiles brought in ahead by TMA bulk
// copies, tile_ring.cuh) and closest_hit_mxu.cu (the same ring, with a
// tensor-core edge prefilter in front of the pair test), and the windowed
// any-hit kernels anyhit.cu (plain loads) and anyhit_pipe.cu (the ring).  All
// five walk the tile order in the group walk below and run exactly the pair
// test below, so on the same rays, tiles and order the closest-hit kernels'
// (t, slot) are bit-equal, the two any-hit kernels' bits are equal, and an
// any-hit bit agrees with the closest hit's t on the same ray.
//
// Layout (packed by gpu_pathtracer_tpu_torch/ops/closest_hit.py):
//   rays  (R, 8)            f32  [ox oy oz dx dy dz t_cap t_near], R % 128 == 0;
//                                t_near is the any-hit kernels' and 0 for closest hit
//   tris  (NT, 10, TILE)    f32  rows v1xyz v2xyz v3xyz tol; empty rows are
//                                zero with tol = +inf (det == 0 -> miss)
//   aabb  (NT, 8)           f32  [min xyz, max xyz, 0, 0]; empty tiles inverted
//   order (R / 128, NT)     i32  the front-to-back tile order of each 128 rays
//
// Arithmetic: built with -fmad=false and without fast math, so the edge
// functions e = a*b - c*d are not contracted into FMAs and the divisions
// (sx, sy, sz, 1/det) are IEEE-rounded; the plain PyTorch versions compute
// the same expressions in the same order.

#pragma once

#include <cuda_runtime.h>

namespace gpt {

constexpr int kBlock = 128;  // rays per row of `order`
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

// The origin box and max |d|_inf of a 128-ray row of `order`.
struct RowBox {
  float lo_x, lo_y, lo_z, hi_x, hi_y, hi_z, dmax;
};

// Chebyshev lower bound from the row's origin box to a tile box (the host
// sorted `order` by the same formula).
__device__ __forceinline__ float tile_lb(const float* __restrict__ b, const RowBox& bb) {
  return fmaxf(
      fmaxf(fmaxf(b[0] - bb.hi_x, bb.lo_x - b[3]), fmaxf(b[1] - bb.hi_y, bb.lo_y - b[4])),
      fmaxf(fmaxf(b[2] - bb.hi_z, bb.lo_z - b[5]), 0.0f));
}

// Per-ray slab test within the ray's budget (its best t, or what is left of
// its any-hit window); max(tlo, 0) makes a dead ray's budget of -1 (or a
// padding ray's 0) cull every box.
__device__ __forceinline__ bool slab_hit(const float* __restrict__ b, const Ray& q,
                                         float budget) {
  const float t0x = (b[0] - q.ox) * q.inv_dx, t1x = (b[3] - q.ox) * q.inv_dx;
  const float t0y = (b[1] - q.oy) * q.inv_dy, t1y = (b[4] - q.oy) * q.inv_dy;
  const float t0z = (b[2] - q.oz) * q.inv_dz, t1z = (b[5] - q.oz) * q.inv_dz;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (thi >= tlo) && (thi > 0.0f) && (fmaxf(tlo, 0.0f) < budget);
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

// ---- the group walk of all five kernels ------------------------------------
// A group of kGroupRays rays is one CUDA block, kRayThreads threads per ray
// (ray = tid / kRayThreads, so a ray's threads are neighbouring lanes of one
// warp).  Each ray has a budget, the reach within which a tile can still
// change its answer (the `Scan` keeps the ray's state and says: its best t
// for the closest hit, what is left of its window for the any hit).  A group
// none of whose rays has a budget above 0 (dead, padding or settled rays)
// ends its walk at the row's first entry, before reading the row; the walk
// below would end there too.  The others walk the row of `order` of the
// 128-ray block they belong to, kBatch entries at a time:
//   1. kBatch threads load the entries and their tile boxes together; the
//      Chebyshev bound of each box from the row's origin box (the quantity
//      the row is sorted by, so it rises along the row);
//   2. every ray's slab test of the batch's boxes against its budget, the
//      votes OR-ed into one candidate bit per entry (warp reduction, one
//      barrier), the group's max budget in the same pass; the batch's first
//      entry whose bound no ray can reach (lb * (1 - 1e-6) >= max budget *
//      the row's max |d|_inf) ends the walk there;
//   3. the candidates in order: the early exit re-checked against the
//      group's up-to-date max budget, the tile staged, and the tile scanned
//      for each ray (ExactScan: each thread testing every kRayThreads-th
//      column, and a shuffle minimum over (t, column); WindowScan: the same
//      columns against the window, the two bits OR-ed over the ray's threads).
// Budgets only shrink.  A tile voted in on an older budget can only be
// scanned without effect, and a tile that none of the group's rays reaches
// within its budget holds no pair that changes their answers, so the answers
// are those of a walk that scans every tile the ray reaches (the 128-ray
// block walk of the TPU kernels).  Once every ray of a group is settled (an
// any-hit ray with its near bit set has budget -1) the next re-check fails
// and the group leaves.  The kernels differ only in how a candidate tile
// reaches shared memory (the `Stager`) and in how a tile is scanned (the
// `Scan`), never in the walk: on the same rays, tiles and order the kernels
// of one query walk and scan the same entries group by group.

constexpr int kGroupRays = 8;    // rays per group: one CUDA block
constexpr int kRayThreads = 8;   // threads per ray
constexpr int kBatch = 32;       // order entries culled together: one bit each
constexpr int kGroupThreads = kGroupRays * kRayThreads;
constexpr int kGroupWarps = kGroupThreads / 32;
static_assert(kBlock % kGroupRays == 0, "a group lies inside one 128-ray row of `order`");
static_assert(kGroupThreads % 32 == 0 && kGroupThreads <= 1024, "whole warps, one block");
static_assert(32 % kRayThreads == 0, "a ray's threads share a warp");
static_assert(kBatch <= 32 && kBatch <= kGroupThreads, "one vote bit and one loader per entry");

// Shared memory of the walk, tile buffers apart.  The batch's entries are
// double-buffered by batch parity and the reductions' slots alternate, so
// one barrier per batch load and one per reduction suffice.
struct WalkShared {
  float box[2][kBatch][8];
  float lb[2][kBatch];
  int ti[2][kBatch];
  float best[2][kGroupWarps];
  unsigned vote[2][kGroupWarps];
  float red[7][kGroupWarps];
};

// The origin box and max |d|_inf of the 128 rays of `row`, read by the
// group's threads together.  One barrier.
__device__ __forceinline__ RowBox row_box(const float* __restrict__ rays, long long row,
                                          float (*s_red)[kGroupWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float red[7] = {kInf, kInf, kInf, -kInf, -kInf, -kInf, 0.0f};
  for (int i = threadIdx.x; i < kBlock; i += kGroupThreads) {
    const float* r = rays + (row * kBlock + i) * 8;
    red[0] = fminf(red[0], r[0]);
    red[1] = fminf(red[1], r[1]);
    red[2] = fminf(red[2], r[2]);
    red[3] = fmaxf(red[3], r[0]);
    red[4] = fmaxf(red[4], r[1]);
    red[5] = fmaxf(red[5], r[2]);
    red[6] = fmaxf(red[6], fmaxf(fmaxf(fabsf(r[3]), fabsf(r[4])), fabsf(r[5])));
  }
  for (int i = 0; i < 3; ++i) red[i] = warp_min(red[i]);
  for (int i = 3; i < 7; ++i) red[i] = warp_max(red[i]);
  if (lane == 0)
    for (int i = 0; i < 7; ++i) s_red[i][warp] = red[i];
  __syncthreads();
  RowBox b = {s_red[0][0], s_red[1][0], s_red[2][0], s_red[3][0],
              s_red[4][0], s_red[5][0], s_red[6][0]};
  for (int w = 1; w < kGroupWarps; ++w) {
    b.lo_x = fminf(b.lo_x, s_red[0][w]);
    b.lo_y = fminf(b.lo_y, s_red[1][w]);
    b.lo_z = fminf(b.lo_z, s_red[2][w]);
    b.hi_x = fmaxf(b.hi_x, s_red[3][w]);
    b.hi_y = fmaxf(b.hi_y, s_red[4][w]);
    b.hi_z = fmaxf(b.hi_z, s_red[5][w]);
    b.dmax = fmaxf(b.dmax, s_red[6][w]);
  }
  return b;
}

// Group max of `v` and group OR of `bits` (one barrier); `ph` picks the
// reduction slot and flips.
__device__ __forceinline__ float group_max_or(float v, unsigned bits, WalkShared& s, int& ph,
                                              unsigned& any_bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float m = warp_max(v);
  const unsigned b = __reduce_or_sync(kFull, bits);
  if (lane == 0) {
    s.best[ph][warp] = m;
    s.vote[ph][warp] = b;
  }
  __syncthreads();
  float g = s.best[ph][0];
  unsigned o = s.vote[ph][0];
  for (int w = 1; w < kGroupWarps; ++w) {
    g = fmaxf(g, s.best[ph][w]);
    o |= s.vote[ph][w];
  }
  ph ^= 1;
  any_bits = o;
  return g;
}

// This thread's share of a staged tile: columns part, part + kRayThreads,
// ... in rising order, the best (t, column) under strict `<` from `best_t`
// (column -1: nothing below best_t).
__device__ __forceinline__ void scan_tile_part(const float* __restrict__ s_tile, int tile, int part,
                                               const Ray& q, float best_t, float& t_out,
                                               int& c_out) {
  float bt = best_t;
  int bc = -1;
  for (int c = part; c < tile; c += kRayThreads) {
    float t;
    if (woop_pair(s_tile, tile, c, q, t) && t < bt && t <= q.t_cap) {
      bt = t;
      bc = c;
    }
  }
  t_out = bt;
  c_out = bc;
}

// Minimum over a ray's threads of (t, column): the smaller t, on equal t the
// smaller column (-1, nothing found, only ties with nothing found).  Every
// thread of the ray ends with the same pair.
__device__ __forceinline__ void ray_min(float& t, int& c) {
#pragma unroll
  for (int off = 1; off < kRayThreads; off <<= 1) {
    const float ot = __shfl_xor_sync(kFull, t, off);
    const int oc = __shfl_xor_sync(kFull, c, off);
    if (ot < t || (ot == t && oc < c)) {
      t = ot;
      c = oc;
    }
  }
}

// Whether any of this ray's threads holds `p` (every thread of the warp
// calls it; every thread of the ray gets the same answer).
__device__ __forceinline__ bool ray_any(bool p) {
  const unsigned lanes = ((1u << kRayThreads) - 1u) << ((threadIdx.x & 31) & ~(kRayThreads - 1));
  return (__ballot_sync(kFull, p) & lanes) != 0u;
}

// ---- the Scans: a query's per-ray state, its tile scan and its outputs ----
//   start(q)            the ray's state before the walk;
//   budget(q)           what the walk culls against (above);
//   scan(buf, tile, part, q, base)  the staged tile (slot of its column 0:
//                       base) against the ray, on all of the ray's threads;
//   write(ray, part)    the ray's outputs (all threads call it, at the end);
//   kCounts, count(out, scanned)  further per-group counts after the walk's
//                       three (all threads call it, at the end).

// The closest hit's state: the best (t, slot) so far; the budget is best t.
struct ClosestHit {
  float* out_t;
  int* out_slot;
  float best_t = 0.0f;
  int best_slot = -1;

  __device__ ClosestHit(float* t, int* slot) : out_t(t), out_slot(slot) {}
  __device__ void start(const Ray& q) {
    best_t = fminf(kInf, q.t_cap);
    best_slot = -1;
  }
  __device__ float budget(const Ray&) const { return best_t; }
  // the ray's best (t, column) in a tile, column -1: nothing below best t
  __device__ void take(float t, int c, int base) {
    if (c >= 0) {
      best_t = t;
      best_slot = base + c;
    }
  }
  __device__ void write(long long ray, int part) const {
    if (part == 0) {
      out_t[ray] = best_t;
      out_slot[ray] = best_slot;
    }
  }
};

// The Scan of B1 and B2: every pair of the tile through the exact test.
struct ExactScan : ClosestHit {
  static constexpr int kCounts = 0;
  using ClosestHit::ClosestHit;
  __device__ void scan(const float* __restrict__ s_tile, int tile, int part, const Ray& q,
                       int base) {
    float t;
    int c;
    scan_tile_part(s_tile, tile, part, q, best_t, t, c);
    ray_min(t, c);
    take(t, c, base);
  }
  __device__ void count(int*, int) {}
};

// ---- windowed any-hit (anyhit.cu, anyhit_pipe.cu) --------------------------
// Per ray two bits: far = some accepted hit with t <= t_cap, near = some
// accepted hit with t <= t_cap and t < t_near (strict).  near implies far.

// What is left of a ray's window: nothing (-1) once near is set, [.., t_near)
// once only far is set, else [.., t_cap].  Drives the tile culls only.
__device__ __forceinline__ float anyhit_budget(const Ray& q, bool near, bool far) {
  return near ? -1.0f : (far ? q.t_near : q.t_cap);
}

// The Scan of B3 and B4.  A ray with nothing left of its window at the
// tile's start (budget < 0: near set, a dead or padding ray, or far set and
// no near window) does no pair test.  Otherwise each of its threads tests
// columns part, part + kRayThreads, ... against t_cap and t_near, never
// against the budget, and stops at its own near hit; the bits are ORs over
// the ray's threads (a thread that stopped early still joins them), so no
// order between columns matters.  A tile scanned on a budget that was already
// out of date can only find hits that the ray's bits record.
struct WindowScan {
  static constexpr int kCounts = 0;
  unsigned char* out_near;
  unsigned char* out_far;
  bool near = false, far = false;

  __device__ WindowScan(unsigned char* n, unsigned char* f) : out_near(n), out_far(f) {}
  __device__ void start(const Ray&) { near = far = false; }
  __device__ float budget(const Ray& q) const { return anyhit_budget(q, near, far); }
  __device__ void scan(const float* __restrict__ s_tile, int tile, int part, const Ray& q, int) {
    bool n = false, f = false;
    if (!(budget(q) < 0.0f)) {
      for (int c = part; c < tile; c += kRayThreads) {
        float t;
        if (woop_pair(s_tile, tile, c, q, t) && t <= q.t_cap) {
          f = true;
          if (t < q.t_near) {
            n = true;
            break;
          }
        }
      }
    }
    near = ray_any(n) || near;
    far = ray_any(f) || far;
  }
  __device__ void write(long long ray, int part) const {
    if (part == 0) {
      out_near[ray] = near ? 1 : 0;
      out_far[ray] = far ? 1 : 0;
    }
  }
  __device__ void count(int*, int) {}
};

// ---- staging and the walk ---------------------------------------------------
// A `Stager` brings candidate tiles to shared memory:
//   begin_batch(ti, mask)  the batch's candidate tiles (ti[k] for the set bits
//                          of mask, in rising k), after the vote's barrier;
//   acquire()              the next candidate's staged tile, visible to all;
//   release()              after the barrier that ends that tile's scan;
//   drain()                at the end: nothing in flight afterwards;
//   fetched                tiles brought in.
// PlainStager (B1, B3) stages a candidate with plain loads when its scan
// begins; tile_ring.cuh's RingStager (B2, B4, B5) brings candidates in ahead.

struct PlainStager {
  float* buf;
  const float* tris;
  int tile;
  const int* ti;
  unsigned pending;
  int fetched;

  __device__ void begin_batch(const int* batch_ti, unsigned mask) {
    ti = batch_ti;
    pending = mask;
  }
  __device__ const float* acquire() {
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    const float* src = tris + (long long)ti[k] * kTileRows * tile;
    for (int i = threadIdx.x; i < kTileRows * tile; i += kGroupThreads) buf[i] = src[i];
    __syncthreads();
    ++fetched;
    return buf;
  }
  __device__ void release() {}
  __device__ void drain() {}
};

// The walk of group `group` by this block (all its threads).  out_counts
// (null or per group [entries walked, tiles fetched, tiles scanned] and the
// Scan's kCounts) and out_cycles (null or per group [clock64 of the walk, of
// it in staging + scanning + the reduction after each scan]) are written by
// thread 0.  A block may walk several groups one after another with the same
// Stager and Scan (the Scan's start() resets the ray's state).
template <class Stager, class Scan>
__device__ __forceinline__ void group_walk(long long group, const float* __restrict__ rays,
                                           const float* __restrict__ aabb,
                                           const int* __restrict__ order,
                                           int* __restrict__ out_counts,
                                           long long* __restrict__ out_cycles, int n_tiles,
                                           int tile, WalkShared& s, Stager& st, Scan& sc) {
  const int tid = threadIdx.x, lane = tid & 31, part = tid % kRayThreads;
  const long long ray = group * kGroupRays + tid / kRayThreads;
  const long long row = (group * kGroupRays) / kBlock;
  const long long walk_start = clock64();
  const Ray q = load_ray(rays + ray * 8);
  sc.start(q);

  const int fetched_before = st.fetched;
  int n_walked = 1, n_scanned = 0, ph = 0;
  long long scan_cycles = 0;
  unsigned none;
  // a group without a budget: the walk would end at the first entry
  const bool live = group_max_or(sc.budget(q), 0u, s, ph, none) > 0.0f;
  const RowBox bb = live ? row_box(rays, row, s.red) : RowBox{};
  const int* my_order = order + row * n_tiles;
  bool walking = live;
  for (int s0 = 0; walking && s0 < n_tiles; s0 += kBatch) {
    const int bp = (s0 / kBatch) & 1;
    const int nb = min(kBatch, n_tiles - s0);
    if (tid < nb) {
      const int ti = my_order[s0 + tid];
      const float4* b4 = reinterpret_cast<const float4*>(aabb + (long long)ti * 8);
      const float4 lo = b4[0], hi = b4[1];
      float* b = s.box[bp][tid];
      b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w;
      b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
      s.ti[bp][tid] = ti;
      s.lb[bp][tid] = tile_lb(b, bb);
    }
    __syncthreads();
    const float budget = sc.budget(q);
    unsigned bits = 0;
    for (int k = part; k < nb; k += kRayThreads)
      if (slab_hit(s.box[bp][k], q, budget)) bits |= 1u << k;
    unsigned mask;
    float group_budget = group_max_or(budget, bits, s, ph, mask);
    // the batch's first entry that no ray of the group can reach
    const unsigned stops = __ballot_sync(
        kFull, lane < nb && !(s.lb[bp][lane] * kLbSlack < group_budget * bb.dmax));
    const int stop = stops ? __ffs(stops) - 1 : nb;
    mask &= stop >= 32 ? kFull : (1u << stop) - 1u;

    st.begin_batch(s.ti[bp], mask);
    int exit_at = -1;
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      if (!(s.lb[bp][k] * kLbSlack < group_budget * bb.dmax)) {
        exit_at = k;
        break;
      }
      const long long scan_start = clock64();
      sc.scan(st.acquire(), tile, part, q, s.ti[bp][k] * tile);
      // also: every thread is done with the staged tile
      group_budget = group_max_or(sc.budget(q), 0u, s, ph, none);
      st.release();
      ++n_scanned;
      scan_cycles += clock64() - scan_start;
    }
    if (exit_at >= 0) {
      n_walked = s0 + exit_at + 1;
      walking = false;
    } else if (stop < nb) {
      n_walked = s0 + stop + 1;
      walking = false;
    } else {
      n_walked = s0 + nb;
    }
  }
  st.drain();

  sc.write(ray, part);
  constexpr int kStride = 3 + Scan::kCounts;
  if (out_counts != nullptr) sc.count(out_counts + group * kStride + 3, n_scanned);
  if (tid == 0) {
    if (out_counts != nullptr) {
      int* c = out_counts + group * kStride;
      c[0] = n_walked;
      c[1] = st.fetched - fetched_before;
      c[2] = n_scanned;
    }
    if (out_cycles != nullptr) {
      out_cycles[2 * group] = clock64() - walk_start;
      out_cycles[2 * group + 1] = scan_cycles;
    }
  }
}

// ---- the any-hit kernels' launch: dead groups apart, live groups pulled ----
// A gather's visibility query holds mostly dead slots (4,194,304 rays of
// which a few thousand are live on the SPPM box), and a block per 8-ray group
// would spend the launch scheduling blocks that only find their rays dead.
// So the any-hit kernels run in two launches on one stream:
//   1. settle_dead_groups: a thread a ray; a group none of whose rays has a
//      window (t_cap <= 0 or NaN, its budget before the walk) gets what its
//      walk would give (bits 0, counts [1, 0, 0]), and the other groups are
//      appended to the live list (one atomic a block);
//   2. a grid that fills the card once walks the live groups, each block
//      pulling the list's next entry with an atomic when it is done with a
//      group (walk_live; measured against a static share of the list, which
//      lost 25% on the mesh's all-live gather rays, whose groups' walks
//      differ by up to 10x).
// The live list: [n_live, next, group ids...] int32, both counters zeroed
// before the first launch; its order (the blocks' atomics) changes no
// group's result.

// Rays' outputs and counts of the groups without a window; the others listed.
static __global__ void __launch_bounds__(kBlock)
settle_dead_groups(const float* __restrict__ rays, unsigned char* __restrict__ out_near,
                   unsigned char* __restrict__ out_far, int* __restrict__ out_counts,
                   long long* __restrict__ out_cycles, int* __restrict__ live) {
  static_assert(kGroupRays <= 32 && 32 % kGroupRays == 0, "a group's rays share a warp");
  constexpr int kWarpsHere = kBlock / 32;
  __shared__ unsigned s_leaders[kWarpsHere];
  __shared__ int s_base;
  const long long start = clock64();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long group = ray / kGroupRays;
  const unsigned lanes = kGroupRays == 32 ? kFull
                                          : ((1u << (kGroupRays % 32)) - 1u)
                                                << (lane & ~(kGroupRays - 1));
  const bool group_live = (__ballot_sync(kFull, rays[ray * 8 + 6] > 0.0f) & lanes) != 0u;
  // the live groups' first lanes, counted over the block for one atomic
  const bool leader = group_live && threadIdx.x % kGroupRays == 0;
  const unsigned leaders = __ballot_sync(kFull, leader);
  if (lane == 0) s_leaders[warp] = leaders;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < kWarpsHere; ++w) n += __popc(s_leaders[w]);
    s_base = n > 0 ? atomicAdd(live, n) : 0;
  }
  __syncthreads();
  if (leader) {
    int at = s_base + __popc(leaders & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += __popc(s_leaders[w]);
    live[2 + at] = (int)group;
  }
  if (group_live) return;
  out_near[ray] = 0;
  out_far[ray] = 0;
  if (threadIdx.x % kGroupRays != 0) return;
  if (out_counts != nullptr) {
    int* c = out_counts + group * 3;
    c[0] = 1;
    c[1] = 0;
    c[2] = 0;
  }
  if (out_cycles != nullptr) {
    out_cycles[2 * group] = clock64() - start;
    out_cycles[2 * group + 1] = 0;
  }
}

// The live groups that this block pulls, each walked in turn.
template <class Stager>
__device__ __forceinline__ void walk_live(const float* __restrict__ rays,
                                          const float* __restrict__ aabb,
                                          const int* __restrict__ order,
                                          int* __restrict__ out_counts,
                                          long long* __restrict__ out_cycles, int n_tiles,
                                          int tile, int* __restrict__ live, WalkShared& s,
                                          Stager& st, WindowScan& sc) {
  __shared__ int s_next;
  const int n_live = live[0];
  for (;;) {
    // the barrier also ends the last group's reads of the walk's shared
    // memory; every thread reads s_next before the walk's first barrier
    if (threadIdx.x == 0) s_next = atomicAdd(live + 1, 1);
    __syncthreads();
    const int i = s_next;
    if (i >= n_live) break;
    group_walk(live[2 + i], rays, aabb, order, out_counts, out_cycles, n_tiles, tile, s, st, sc);
  }
}

// Both launches of an any-hit kernel (`walk` its kernel of walk_live, `smem`
// its dynamic shared memory); returns cudaGetLastError().  `live` is the
// live list, (n_rays / kGroupRays + 2) int32.
template <class Walk>
__host__ int launch_window(Walk walk, size_t smem, const float* rays, const float* tris,
                           const float* aabb, const int* order, unsigned char* out_near,
                           unsigned char* out_far, int* out_counts, long long* out_cycles,
                           int* live, int n_rays, int n_tiles, int tile, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk, kGroupThreads, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(live, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  settle_dead_groups<<<n_rays / kBlock, kBlock, 0, stream>>>(rays, out_near, out_far, out_counts,
                                                             out_cycles, live);
  const long long groups = n_rays / kGroupRays;
  const int grid = (int)(groups < (long long)sms * per_sm ? groups : (long long)sms * per_sm);
  walk<<<grid > 0 ? grid : 1, kGroupThreads, smem, stream>>>(
      rays, tris, aabb, order, out_near, out_far, out_counts, out_cycles, live, n_tiles, tile);
  return (int)cudaGetLastError();
}

}  // namespace gpt
