// Ring-buffered windowed any-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_anyhit_kernel_big`
// (gpu_pathtracer_tpu/ops/pallas_trace.py), the any-hit query of scenes above
// PALLAS_MAX triangles: anyhit.cu's query, bits, budgets and walk
// (closest_hit_common.cuh), with the candidate tiles brought in ahead by the
// Tensor Memory Accelerator into closest_hit_pipe.cu's ring (tile_ring.cuh,
// `RingStager`, one bulk copy of 5,120 bytes per 128-triangle tile, at B2's
// depth), launched as anyhit.cu (dead groups settled first, the live ones
// pulled by the blocks of a grid that fills the card once; a block's ring
// carries over from group to group).  The ring starts the batch's candidates in order after the batch's
// vote, so at a failed re-check up to kRing tiles are fetched and not
// scanned; otherwise the kernel walks and scans the same entries as
// anyhit.cu, group by group.  A tile copied in but not scanned changes
// nothing, and a scanned tile can only find hits that the ray's bits already
// record once its budget is out of date, so both bits equal anyhit.cu's on
// every ray of the same rays, tiles and order.
//
// What bounds it on this card: as closest_hit_pipe.cu, the slowest group's
// walk of its row (2,561 entries on the 327,684-triangle mesh) and fp32 ALU
// work on the tiles that survive the cull; the tiles (13 MB) stay in the
// 50 MB L2, so the latency the ring hides is L2's.  The rays' budgets
// shrink as their bits settle, so settled groups leave early.

#include <cstdint>

#include "closest_hit_common.cuh"
#include "tile_ring.cuh"

using namespace gpt;

namespace {

constexpr int kRing = 1;       // tile buffers in flight: B2's depth (closest_hit_pipe.cu)
constexpr int kMaxTile = 512;  // up to kRing = 2 buffers * 10 rows * kMaxTile * 4 B <= 40 KB

__global__ void __launch_bounds__(kGroupThreads)
anyhit_pipe_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                   const float* __restrict__ aabb, const int* __restrict__ order,
                   unsigned char* __restrict__ out_near, unsigned char* __restrict__ out_far,
                   int* __restrict__ out_counts, long long* __restrict__ out_cycles,
                   int* __restrict__ live, int n_tiles, int tile) {
  extern __shared__ __align__(128) float s_buf[];  // (kRing, 10, tile)
  __shared__ WalkShared s;
  __shared__ __align__(8) uint64_t s_bar[kRing];
  const TileOperands<1> ops{{reinterpret_cast<const char*>(tris)},
                            {(uint32_t)(kTileRows * tile * sizeof(float))}};
  RingStager<kRing, 1> st(s_buf, s_bar, ops);
  st.init();
  __syncthreads();
  WindowScan sc(out_near, out_far);
  walk_live(rays, aabb, order, out_counts, out_cycles, n_tiles, tile, live, s, st, sc);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Inputs and outputs as gpt_anyhit's;
// `out_counts` is null or (n_rays / kGroupRays, 3) int32: per group the order
// entries walked, the tiles fetched and the tiles scanned; `out_cycles` is
// null or (n_rays / kGroupRays, 2) int64: per group the clock64 cycles of the
// walk and of its waiting and scanning.
extern "C" int gpt_anyhit_pipe(const float* rays, const float* tris, const float* aabb,
                               const int* order, int* live, unsigned char* out_near,
                               unsigned char* out_far, int* out_counts, long long* out_cycles,
                               int n_rays, int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      tile % 4 != 0 || reinterpret_cast<size_t>(tris) % 16 != 0 ||
      reinterpret_cast<size_t>(aabb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kRing * kTileRows * tile * sizeof(float);
  return launch_window(anyhit_pipe_kernel, smem, rays, tris, aabb, order, out_near, out_far,
                       out_counts, out_cycles, live, n_rays, n_tiles, tile, (cudaStream_t)stream);
}
