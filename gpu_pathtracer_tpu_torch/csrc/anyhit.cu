// Windowed any-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_anyhit_kernel`
// (gpu_pathtracer_tpu/ops/pallas_trace.py): for every ray two bits,
// far = "some accepted hit with t <= t_cap" and near = "some accepted hit
// with t < t_near" (t_near <= t_cap, so near implies far).  The photon
// gathers' visibility verdict is far & ~near.  Layouts and the pair test are
// in closest_hit_common.cuh, shared with the closest-hit kernels, so a bit
// agrees with the closest hit's t on the same ray.
//
// One thread per ray, 128 rays per block, the block's own front-to-back row
// of `order`, as closest_hit.cu.  There is no best t to refine: a ray is
// settled by its first accepted hit inside its window.  Each thread keeps its
// two bits and the budget they leave (-1 once near is set, t_near once only
// far is set, else t_cap).  Per tile the block takes the max of the budgets
// and a vote on the slab test within them in one reduction; the walk ends at
// the first tile whose Chebyshev lower bound no budget reaches, which is at
// once when every ray is settled; a voted tile is staged in shared memory and
// scanned by the threads that still have a window.
//
// What bounds it on this card: as closest_hit.cu, fp32 ALU work on the
// (ray, triangle) pairs of the scanned tiles, and on large scenes the
// per-tile walk (two dependent loads and a barrier per order entry).  The
// budgets cut both: settled rays stop voting, so blocks leave early.

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kMaxTile = 1024;  // 10 rows * 1024 * 4 B = 40 KB of shared memory

__global__ void __launch_bounds__(kBlock)
anyhit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
              const float* __restrict__ aabb, const int* __restrict__ order,
              unsigned char* __restrict__ out_near, unsigned char* __restrict__ out_far,
              int* __restrict__ out_counts, int n_tiles, int tile) {
  extern __shared__ float s_tile[];  // (10, tile)
  __shared__ float s_box[7][kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_any[kWarps];

  const int tid = threadIdx.x;
  const long long ray = (long long)blockIdx.x * kBlock + tid;
  const Ray q = load_ray(rays + ray * 8);
  const BlockBox bb = block_box(q, s_box);

  bool near = false, far = false;
  const int* my_order = order + (long long)blockIdx.x * n_tiles;
  int n_steps = 0, n_computed = 0;

  for (int j = 0; j < n_tiles; ++j) {
    ++n_steps;
    const int ti = my_order[j];
    const float* b = aabb + (long long)ti * 8;
    const float budget = anyhit_budget(q, near, far);
    float block_budget;
    bool any;
    block_max_any(budget, slab_hit(b, q, budget), s_best, s_any, block_budget, any);
    // uniform across the block: every value in it is block-wide
    if (!(tile_lb(b, bb) * kLbSlack < block_budget * bb.dmax)) break;

    if (any) {
      const float* src = tris + (long long)ti * kTileRows * tile;
      for (int i = tid; i < kTileRows * tile; i += kBlock) s_tile[i] = src[i];
      __syncthreads();
      scan_tile_anyhit(s_tile, tile, q, budget, near, far);
      ++n_computed;
    }
    __syncthreads();  // s_tile / s_best / s_any are rewritten next tile
  }

  out_near[ray] = near ? 1 : 0;
  out_far[ray] = far ? 1 : 0;
  if (out_counts != nullptr && tid == 0) {
    int* c = out_counts + (long long)blockIdx.x * 3;
    c[0] = n_steps;
    c[1] = n_computed;  // every staged tile is scanned
    c[2] = n_computed;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_near` / `out_far` are (n_rays,)
// bytes, 0 or 1.  `out_counts` is null or (n_rays / 128, 3) int32: per block
// the tile steps walked, the tiles staged and the tiles scanned.
extern "C" int gpt_anyhit(const float* rays, const float* tris, const float* aabb,
                          const int* order, unsigned char* out_near, unsigned char* out_far,
                          int* out_counts, int n_rays, int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kTileRows * tile * sizeof(float);
  anyhit_kernel<<<n_rays / kBlock, kBlock, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_near, out_far, out_counts, n_tiles, tile);
  return (int)cudaGetLastError();
}
