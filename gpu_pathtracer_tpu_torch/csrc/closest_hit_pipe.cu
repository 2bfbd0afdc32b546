// Double-buffered closest-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel_big_pipe`
// (gpu_pathtracer_tpu/ops/pallas_trace.py), the closest-hit query of scenes
// above PALLAS_MAX triangles: the same query, layouts and pair arithmetic as
// closest_hit.cu (closest_hit_common.cuh), with the tile copies taken off the
// critical path.
//
// One thread per ray, 128 rays per block; a block walks its own row of
// `order` front to back.  Two tile buffers live in shared memory.  While the
// block scans tile j in one buffer, the copy of tile j+1 into the other is
// already in flight (cp.async, 16-byte chunks, one commit group per step).
// The decision to prefetch tile j+1 is made BEFORE tile j's pairs, from the
// best_t of that moment: Chebyshev bound, block slab vote, and only if the
// walk goes on past tile j.  best_t only shrinks, so the decision is
// conservative: at most one tile is fetched that the up-to-date cull would
// have skipped, and none is missed.  The decision is block-uniform and rides
// to the next iteration, so every started copy is waited exactly once and
// none is in flight when the block leaves the loop.
//
// A tile that is scanned although the up-to-date slab vote would have culled
// it cannot change the result (no pair in it has t < best_t), and ties across
// tiles keep the earlier tile, so (t, slot) equal closest_hit.cu's bit for
// bit on the same rays, tiles and order.
//
// What bounds it on this card: as closest_hit.cu, fp32 ALU work on the
// (ray, triangle) pairs of the tiles that survive the cull.  The 327,684-
// triangle mesh packs into 13 MB of tiles, which stay in the 50 MB L2, so
// the latency the prefetch hides is L2's (a few hundred cycles per 5 KB
// tile), against ~128 x 128 pair tests per tile.

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
closest_hit_pipe_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                        const float* __restrict__ aabb, const int* __restrict__ order,
                        float* __restrict__ out_t, int* __restrict__ out_slot,
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

  float best_t = fminf(kInf, q.t_cap);
  int best_slot = -1;
  const int* my_order = order + (long long)blockIdx.x * n_tiles;
  int n_steps = 0, n_fetched = 0, n_computed = 0;

  // probe tile 0 with the initial best_t
  int ti_cur = my_order[0];
  bool ah;  // a copy of tile j was started (block-uniform)
  {
    const float* b = aabb + (long long)ti_cur * 8;
    float block_best;
    bool any;
    block_max_any(best_t, slab_hit(b, q, best_t), s_best, s_any, block_best, any);
    ah = (tile_lb(b, bb) * kLbSlack < block_best * bb.dmax) && any;
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

    // one reduction serves both decisions: block max(best_t), and the vote
    // on tile j+1's slab test, both with the best_t from before tile j's pairs
    float block_best;
    bool any_next;
    block_max_any(best_t, slab_hit(bn, q, best_t), s_best, s_any, block_best, any_next);
    const float reach = block_best * bb.dmax;
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
        scan_tile(s_buf + (j & 1) * tile_floats, tile, ti_cur * tile, q, best_t, best_slot);
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

  out_t[ray] = best_t;
  out_slot[ray] = best_slot;
  if (out_counts != nullptr && tid == 0) {
    int* c = out_counts + (long long)blockIdx.x * 3;
    c[0] = n_steps;
    c[1] = n_fetched;
    c[2] = n_computed;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / 128, 3)
// int32: per block the tile steps walked, the tiles fetched and the tiles
// scanned.
extern "C" int gpt_closest_hit_pipe(const float* rays, const float* tris, const float* aabb,
                                    const int* order, float* out_t, int* out_slot,
                                    int* out_counts, int n_rays, int n_tiles, int tile,
                                    void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      tile % 4 != 0 || reinterpret_cast<size_t>(tris) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)2 * kTileRows * tile * sizeof(float);
  closest_hit_pipe_kernel<<<n_rays / kBlock, kBlock, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_t, out_slot, out_counts, n_tiles, tile);
  return (int)cudaGetLastError();
}
