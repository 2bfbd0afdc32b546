// Windowed any-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_anyhit_kernel`
// (gpu_pathtracer_tpu/ops/pallas_trace.py): for every ray two bits,
// far = "some accepted hit with t <= t_cap" and near = "some accepted hit
// with t < t_near" (t_near <= t_cap, so near implies far).  The photon
// gathers' visibility verdict is far & ~near.  Layouts, the pair test and
// the walk are in closest_hit_common.cuh, shared with the closest-hit
// kernels, so a bit agrees with the closest hit's t on the same ray.
//
// Rays walk in groups of 8 with 8 threads per ray; a group walks the tile
// order of its 128-ray row 32 entries at a time and stages each candidate
// tile with plain loads into one shared-memory buffer (`group_walk`,
// `PlainStager`, as closest_hit.cu).  There is no best t to refine: a ray is
// settled by its first accepted hit inside its window (`WindowScan`).  Each
// ray keeps its two bits and the budget they leave (-1 once near is set,
// t_near once only far is set, else t_cap); the group culls and exits on its
// rays' budgets, so a group whose rays are all settled leaves at its next
// re-check.  A first launch settles the groups of dead or padding rays a
// thread a ray, and the blocks of a grid that fills the card once pull the
// live groups one at a time (`launch_window`), so a gather's query of mostly
// empty slots costs about one pass over its rays.
//
// What bounds it on this card: fp32 ALU work on the (ray, triangle) pairs of
// the scanned tiles at the main path's 72 triangles (one tile), and on the
// gathers' queries of mostly dead rays the bytes of the rays themselves.
// Eight threads a ray cut the chain of serial pair tests of a tile eight
// times over against a thread a ray, and 64-thread blocks with 5 KB tiles
// let an SM hold enough groups to hide their latency.

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kMaxTile = 1024;  // 10 rows * 1024 * 4 B = 40 KB of shared memory

__global__ void __launch_bounds__(kGroupThreads)
anyhit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
              const float* __restrict__ aabb, const int* __restrict__ order,
              unsigned char* __restrict__ out_near, unsigned char* __restrict__ out_far,
              int* __restrict__ out_counts, long long* __restrict__ out_cycles,
              int* __restrict__ live, int n_tiles, int tile) {
  extern __shared__ float s_tile[];  // (10, tile)
  __shared__ WalkShared s;
  PlainStager st{s_tile, tris, tile, nullptr, 0u, 0};
  WindowScan sc(out_near, out_far);
  walk_live(rays, aabb, order, out_counts, out_cycles, n_tiles, tile, live, s, st, sc);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `live` is scratch of (n_rays /
// kGroupRays + 2) int32 (the live list of launch_window).  `out_near` /
// `out_far` are (n_rays,) bytes, 0 or 1.  `out_counts` is null or (n_rays /
// kGroupRays, 3) int32: per group the order entries walked, the tiles staged
// and the tiles scanned; `out_cycles` is null or (n_rays / kGroupRays, 2)
// int64: per group the clock64 cycles of the walk and of its staging and
// scanning.
extern "C" int gpt_anyhit(const float* rays, const float* tris, const float* aabb,
                          const int* order, int* live, unsigned char* out_near,
                          unsigned char* out_far, int* out_counts, long long* out_cycles,
                          int n_rays, int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      reinterpret_cast<size_t>(aabb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kTileRows * tile * sizeof(float);
  return launch_window(anyhit_kernel, smem, rays, tris, aabb, order, out_near, out_far,
                       out_counts, out_cycles, live, n_rays, n_tiles, tile, (cudaStream_t)stream);
}
