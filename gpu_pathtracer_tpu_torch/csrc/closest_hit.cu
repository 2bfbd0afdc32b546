// Closest-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel`
// (gpu_pathtracer_tpu/ops/pallas_trace.py): for every ray, the closest
// watertight-Woop hit among the scene's triangles, returned as (t, slot)
// with slot a row of the Morton-sorted triangle SoA (-1 on a miss).
// Layouts, the pair arithmetic and the walk are in closest_hit_common.cuh,
// shared with the ring-buffered kernel of closest_hit_pipe.cu.
//
// A block is a group of 8 rays with 8 threads per ray; it walks the tile
// order of its 128-ray row 32 entries at a time (one batched cull, one
// candidate mask) and stages each candidate tile with plain loads into one
// shared-memory buffer (`group_walk`).
//
// What bounds it on this card: fp32 ALU work per (ray, triangle) pair
// (~42 flops plus a division for pairs that pass the edge tests), and, on a
// launch, its slowest group.  The tiles are L2-resident at the main path's
// 972 triangles (~40 KB) and each staged tile is read from shared memory as a
// broadcast.  Small groups with several threads per ray shorten the slowest
// group's chain of serial pair tests eight times over and let an SM hold
// enough warps to hide their latency; the batched cull costs two barriers
// per 32 order entries instead of two per entry.

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kMaxTile = 1024;  // 10 rows * 1024 * 4 B = 40 KB of shared memory

// Stages a candidate tile with plain loads, all threads, one barrier.
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

__global__ void __launch_bounds__(kGroupThreads)
closest_hit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                   const float* __restrict__ aabb, const int* __restrict__ order,
                   float* __restrict__ out_t, int* __restrict__ out_slot,
                   int* __restrict__ out_counts, long long* __restrict__ out_cycles,
                   int n_tiles, int tile) {
  extern __shared__ float s_tile[];  // (10, tile)
  __shared__ WalkShared s;
  PlainStager st{s_tile, tris, tile, nullptr, 0u, 0};
  group_walk(rays, aabb, order, out_t, out_slot, out_counts, out_cycles, n_tiles, tile, s, st);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / kGroupRays, 3)
// int32: per group the order entries walked, the tiles staged and the tiles
// scanned; `out_cycles` is null or (n_rays / kGroupRays, 2) int64: per group the
// clock64 cycles of the walk and of its staging and scanning.
extern "C" int gpt_closest_hit(const float* rays, const float* tris, const float* aabb,
                               const int* order, float* out_t, int* out_slot,
                               int* out_counts, long long* out_cycles, int n_rays,
                               int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile <= 0 || tile > kMaxTile ||
      reinterpret_cast<size_t>(aabb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kTileRows * tile * sizeof(float);
  closest_hit_kernel<<<n_rays / kGroupRays, kGroupThreads, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, out_t, out_slot, out_counts, out_cycles, n_tiles, tile);
  return (int)cudaGetLastError();
}
