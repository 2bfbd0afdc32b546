// Closest-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel`
// (gpu_pathtracer_tpu/ops/pallas_trace.py): for every ray, the closest
// watertight-Woop hit among the scene's triangles, returned as (t, slot)
// with slot a row of the Morton-sorted triangle SoA (-1 on a miss).
// Layouts and the pair arithmetic are in closest_hit_common.cuh, shared with
// the double-buffered kernel of closest_hit_pipe.cu.
//
// One thread per ray, 128 rays per block.  A block reduces its rays' origin
// box and max |d|_inf once, then walks its row of `order`: per tile it
// computes the Chebyshev lower bound from the origin box to the tile box and
// stops once lb * (1 - 1e-6) >= max(best_t) * dmax (no later tile can
// improve any ray); it votes on the per-ray slab test against best_t and,
// if any ray's slab reaches the tile, stages the tile's 10 rows in shared
// memory and every thread scans its triangles in order.
//
// What bounds it on this card: fp32 ALU work per (ray, triangle) pair
// (~50 flops plus a division for pairs that pass the edge tests); the tiles
// are L2-resident at the main path's 972 triangles (~40 KB), and each tile
// is read from shared memory as a broadcast.  The design spends that ALU
// budget only where it can matter: the tile cull skips tiles no ray of the
// block can reach, and the front-to-back early exit stops the walk once
// the block's hits are closer than every remaining tile.

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kMaxTile = 1024;  // 10 rows * 1024 * 4 B = 40 KB of shared memory

__global__ void __launch_bounds__(kBlock)
closest_hit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                   const float* __restrict__ aabb, const int* __restrict__ order,
                   float* __restrict__ out_t, int* __restrict__ out_slot,
                   int* __restrict__ out_counts, int n_tiles, int tile) {
  extern __shared__ float s_tile[];  // (10, tile)
  __shared__ float s_box[7][kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_any[kWarps];

  const int tid = threadIdx.x;
  const long long ray = (long long)blockIdx.x * kBlock + tid;
  const Ray q = load_ray(rays + ray * 8);
  const BlockBox bb = block_box(q, s_box);

  float best_t = fminf(kInf, q.t_cap);
  int best_slot = -1;
  const int* my_order = order + (long long)blockIdx.x * n_tiles;
  int n_steps = 0, n_computed = 0;

  for (int j = 0; j < n_tiles; ++j) {
    ++n_steps;
    const int ti = my_order[j];
    const float* b = aabb + (long long)ti * 8;
    const float lb = tile_lb(b, bb);
    float block_best;
    bool any;
    block_max_any(best_t, slab_hit(b, q, best_t), s_best, s_any, block_best, any);
    // uniform across the block: every value in it is block-wide
    if (!(lb * kLbSlack < block_best * bb.dmax)) break;

    if (any) {
      const float* src = tris + (long long)ti * kTileRows * tile;
      for (int i = tid; i < kTileRows * tile; i += kBlock) s_tile[i] = src[i];
      __syncthreads();
      scan_tile(s_tile, tile, ti * tile, q, best_t, best_slot);
      ++n_computed;
    }
    __syncthreads();  // s_tile / s_best / s_any are rewritten next tile
  }

  out_t[ray] = best_t;
  out_slot[ray] = best_slot;
  if (out_counts != nullptr && tid == 0) {
    int* c = out_counts + (long long)blockIdx.x * 3;
    c[0] = n_steps;
    c[1] = n_computed;  // every staged tile is scanned
    c[2] = n_computed;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / 128, 3)
// int32: per block the tile steps walked, the tiles staged and the tiles
// scanned.
extern "C" int gpt_closest_hit(const float* rays, const float* tris, const float* aabb,
                               const int* order, float* out_t, int* out_slot,
                               int* out_counts, int n_rays, int n_tiles, int tile,
                               void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kTileRows * tile * sizeof(float);
  closest_hit_kernel<<<n_rays / kBlock, kBlock, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_t, out_slot, out_counts, n_tiles, tile);
  return (int)cudaGetLastError();
}
