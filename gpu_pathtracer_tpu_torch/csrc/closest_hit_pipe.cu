// Ring-buffered closest-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel_big_pipe`
// (gpu_pathtracer_tpu/ops/pallas_trace.py), the closest-hit query of scenes
// above PALLAS_MAX triangles: the same query, layouts, pair arithmetic and
// walk as closest_hit.cu (closest_hit_common.cuh), with the candidate tiles
// brought in ahead by the Tensor Memory Accelerator (tile_ring.cuh, the ring
// it shares with closest_hit_mxu.cu).
//
// A block is a group of 8 rays with 8 threads per ray walking its 128-ray
// row of `order` 32 entries at a time (`group_walk`).  Up to kRing candidate
// tiles of a batch are in flight at once, each one bulk copy of 5,120 bytes
// per 128-triangle tile (`RingStager`).  The depth is B5's, so that the two
// kernels fetch the same tiles; B2 measured the same within 3% at depths 1
// to 4 (the tiles are L2-resident).
//
// A tile copied in but not scanned changes nothing, so (t, slot) equal
// closest_hit.cu's bit for bit on the same rays, tiles and order, and so do
// the walked and scanned counts.
//
// What bounds it on this card: as closest_hit.cu, fp32 ALU work on the
// (ray, triangle) pairs of the tiles that survive the cull, and the slowest
// group.  The 327,684-triangle mesh packs into 13 MB of tiles, which stay in
// the 50 MB L2, so the latency the ring hides is L2's, a few hundred cycles
// per tile, against 8 rays x 128 triangles of pair tests per tile.

#include <cstdint>

#include "closest_hit_common.cuh"
#include "tile_ring.cuh"

using namespace gpt;

namespace {

constexpr int kRing = 1;       // tile buffers in flight: B5's depth (closest_hit_mxu.cu)
constexpr int kMaxTile = 512;  // up to kRing = 2 buffers * 10 rows * kMaxTile * 4 B <= 40 KB

__global__ void __launch_bounds__(kGroupThreads)
closest_hit_pipe_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                        const float* __restrict__ aabb, const int* __restrict__ order,
                        float* __restrict__ out_t, int* __restrict__ out_slot,
                        int* __restrict__ out_counts, long long* __restrict__ out_cycles,
                        int n_tiles, int tile) {
  extern __shared__ __align__(128) float s_buf[];  // (kRing, 10, tile)
  __shared__ WalkShared s;
  __shared__ __align__(8) uint64_t s_bar[kRing];
  const TileOperands<1> ops{{reinterpret_cast<const char*>(tris)},
                            {(uint32_t)(kTileRows * tile * sizeof(float))}};
  RingStager<kRing, 1> st(s_buf, s_bar, ops);
  st.init();
  __syncthreads();
  ExactScan sc(out_t, out_slot);
  group_walk(blockIdx.x, rays, aabb, order, out_counts, out_cycles, n_tiles, tile, s, st, sc);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / kGroupRays, 3)
// int32: per group the order entries walked, the tiles fetched and the tiles
// scanned; `out_cycles` is null or (n_rays / kGroupRays, 2) int64: per group the
// clock64 cycles of the walk and of its waiting and scanning.
extern "C" int gpt_closest_hit_pipe(const float* rays, const float* tris, const float* aabb,
                                    const int* order, float* out_t, int* out_slot,
                                    int* out_counts, long long* out_cycles, int n_rays,
                                    int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      tile % 4 != 0 || reinterpret_cast<size_t>(tris) % 16 != 0 ||
      reinterpret_cast<size_t>(aabb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kRing * kTileRows * tile * sizeof(float);
  closest_hit_pipe_kernel<<<n_rays / kGroupRays, kGroupThreads, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_t, out_slot, out_counts, out_cycles, n_tiles, tile);
  return (int)cudaGetLastError();
}
