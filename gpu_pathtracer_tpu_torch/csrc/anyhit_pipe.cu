// Double-buffered windowed any-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_anyhit_kernel_big`
// (gpu_pathtracer_tpu/ops/pallas_trace.py), the any-hit query of scenes above
// PALLAS_MAX triangles: anyhit.cu's query, bits and budgets on
// closest_hit_pipe.cu's skeleton.  Two tile buffers live in shared memory;
// while the block scans tile j in one, the copy of tile j+1 into the other is
// in flight (cp.async, 16-byte chunks, one commit group per step, empty when
// nothing was started).  The decision to prefetch tile j+1 is made BEFORE
// tile j's pairs, from the budgets of that moment: Chebyshev bound, block
// slab vote, and only if the walk goes on past tile j.  Budgets only shrink,
// so at most one tile is fetched that the up-to-date cull would have
// skipped, and none is missed.  The decision is block-uniform and rides to
// the next iteration, so every started copy is waited exactly once, and the
// block drains before it returns.
//
// The scan of tile j needs the tile to have been fetched and the walk to
// still go on by the CURRENT budgets.  A tile scanned although the up-to-date
// vote would have culled it can only find hits that the ray's bits already
// record (a thread tests against t_cap and t_near, never against the
// budget, and a thread without a window does no test), so both bits equal
// anyhit.cu's on every ray of the same rays, tiles and order.
//
// What bounds it on this card: as closest_hit_pipe.cu, the per-tile walk of
// the order row on a 2,561-tile scene and fp32 ALU work on the scanned
// tiles; the tiles (13 MB for 327,684 triangles) stay in the 50 MB L2.

#include <cuda_pipeline.h>

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kMaxTile = 512;  // 2 buffers * 10 rows * 512 * 4 B = 40 KB of shared memory

// Start this thread's share of the copy of one packed tile into `dst`
// (shared memory).  `n_chunks` 16-byte chunks; both sides 16-byte aligned.
__device__ __forceinline__ void stage_tile_async(float* dst, const float* __restrict__ src,
                                                 int n_chunks) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n_chunks; i += kBlock)
    __pipeline_memcpy_async(d + i, s + i, sizeof(float4));
}

__global__ void __launch_bounds__(kBlock)
anyhit_pipe_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                   const float* __restrict__ aabb, const int* __restrict__ order,
                   unsigned char* __restrict__ out_near, unsigned char* __restrict__ out_far,
                   int* __restrict__ out_counts, int n_tiles, int tile) {
  extern __shared__ __align__(16) float s_buf[];  // (2, 10, tile)
  __shared__ float s_box[7][kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_any[kWarps];

  const int tid = threadIdx.x;
  const long long ray = (long long)blockIdx.x * kBlock + tid;
  const int tile_floats = kTileRows * tile;
  const int n_chunks = tile_floats / 4;
  const Ray q = load_ray(rays + ray * 8);
  const BlockBox bb = block_box(q, s_box);

  bool near = false, far = false;
  const int* my_order = order + (long long)blockIdx.x * n_tiles;
  int n_steps = 0, n_fetched = 0, n_computed = 0;

  // probe tile 0 with the initial budgets
  int ti_cur = my_order[0];
  bool ah;  // a copy of tile j was started (block-uniform)
  {
    const float* b = aabb + (long long)ti_cur * 8;
    const float budget = anyhit_budget(q, near, far);
    float block_budget;
    bool any;
    block_max_any(budget, slab_hit(b, q, budget), s_best, s_any, block_budget, any);
    ah = (tile_lb(b, bb) * kLbSlack < block_budget * bb.dmax) && any;
  }
  if (ah) {
    stage_tile_async(s_buf, tris + (long long)ti_cur * tile_floats, n_chunks);
    ++n_fetched;
  }
  __pipeline_commit();
  __syncthreads();  // s_best / s_any are rewritten by the loop's first vote

  for (int j = 0; j < n_tiles; ++j) {
    ++n_steps;
    const bool has_next = j + 1 < n_tiles;
    const int ti_next = my_order[has_next ? j + 1 : j];
    const float* b = aabb + (long long)ti_cur * 8;
    const float* bn = aabb + (long long)ti_next * 8;

    // one reduction serves both decisions: block max of the budgets, and the
    // vote on tile j+1's slab test, both from before tile j's pairs
    const float budget = anyhit_budget(q, near, far);
    float block_budget;
    bool any_next;
    block_max_any(budget, slab_hit(bn, q, budget), s_best, s_any, block_budget, any_next);
    const float reach = block_budget * bb.dmax;
    // uniform across the block: every value in them is block-wide
    const bool improve = tile_lb(b, bb) * kLbSlack < reach;
    const bool ah_next =
        has_next && improve && (tile_lb(bn, bb) * kLbSlack < reach) && any_next;

    // prefetch tile j+1 into the other buffer while tile j computes below;
    // suppressed when the walk ends here, so no copy is left in flight
    if (ah_next) {
      stage_tile_async(s_buf + ((j + 1) & 1) * tile_floats,
                       tris + (long long)ti_next * tile_floats, n_chunks);
      ++n_fetched;
    }
    __pipeline_commit();  // one group per step, empty when nothing was started

    if (ah) {
      __pipeline_wait_prior(1);  // all but the group just committed: tile j, this thread's chunks
      __syncthreads();           // ... and every other thread's
      if (improve) {
        scan_tile_anyhit(s_buf + (j & 1) * tile_floats, tile, q, budget, near, far);
        ++n_computed;
      }
    }
    if (!improve) break;
    // buffer (j & 1) is the target of the next step's prefetch, and
    // s_best / s_any are rewritten by its vote
    __syncthreads();
    ah = ah_next;
    ti_cur = ti_next;
  }
  __pipeline_wait_prior(0);  // nothing is in flight here; drain all the same

  out_near[ray] = near ? 1 : 0;
  out_far[ray] = far ? 1 : 0;
  if (out_counts != nullptr && tid == 0) {
    int* c = out_counts + (long long)blockIdx.x * 3;
    c[0] = n_steps;
    c[1] = n_fetched;
    c[2] = n_computed;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Outputs as gpt_anyhit's; `out_counts`
// is null or (n_rays / 128, 3) int32: per block the tile steps walked, the
// tiles fetched and the tiles scanned.
extern "C" int gpt_anyhit_pipe(const float* rays, const float* tris, const float* aabb,
                               const int* order, unsigned char* out_near,
                               unsigned char* out_far, int* out_counts, int n_rays, int n_tiles,
                               int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      tile % 4 != 0 || reinterpret_cast<size_t>(tris) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)2 * kTileRows * tile * sizeof(float);
  anyhit_pipe_kernel<<<n_rays / kBlock, kBlock, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_near, out_far, out_counts, n_tiles, tile);
  return (int)cudaGetLastError();
}
