// Ring-buffered closest-hit tile kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel_big_pipe`
// (gpu_pathtracer_tpu/ops/pallas_trace.py), the closest-hit query of scenes
// above PALLAS_MAX triangles: the same query, layouts, pair arithmetic and
// walk as closest_hit.cu (closest_hit_common.cuh), with the candidate tiles
// brought in ahead by the Tensor Memory Accelerator.
//
// A block is a group of 8 rays with 8 threads per ray walking its 128-ray
// row of `order` 32 entries at a time (`group_walk`).  The batch's vote
// names its candidate tiles before any is scanned, so one thread starts the
// bulk copies (cp.async.bulk, 5,120 bytes per 128-triangle tile, completion
// counted in bytes on an mbarrier) of the first kRing candidates into a ring
// of kRing shared-memory buffers at once, and the copy of candidate i+kRing
// as soon as the group is done with candidate i's buffer.  Buffer b's
// mbarrier completes one phase per fill, so candidate n (counted over the
// whole walk) waits for parity (n / kRing) & 1 of buffer n % kRing.  A
// candidate whose early-exit re-check fails ends the walk with up to kRing
// copies in flight, and the group waits for all of them before it leaves.
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

using namespace gpt;

namespace {

constexpr int kRing = 2;                // tile buffers in flight
constexpr int kMaxTile = 1024 / kRing;  // kRing buffers * 10 rows * kMaxTile * 4 B <= 40 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16; both sides 16-byte aligned)
// from global to shared memory, completing on `bar`.  One thread.
__device__ __forceinline__ void tma_load(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
  // the buffer was last read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Keeps up to kRing candidate tiles in flight.  Every thread tracks the
// same counters; thread 0 starts the copies.
struct RingStager {
  float* buf;  // (kRing, 10, tile)
  uint64_t* bar;
  const float* tris;
  int tile;
  const int* ti;
  unsigned pending;  // candidates of the batch whose copy has not started
  int fetched;       // copies started over the walk
  int consumed;      // candidates acquired over the walk

  __device__ int tile_floats() const { return kTileRows * tile; }
  __device__ void start_copy() {
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    if (threadIdx.x == 0) {
      const int b = fetched % kRing;
      tma_load(buf + b * tile_floats(), tris + (long long)ti[k] * tile_floats(),
               (uint32_t)(tile_floats() * sizeof(float)), bar + b);
    }
    ++fetched;
  }
  __device__ void begin_batch(const int* batch_ti, unsigned mask) {
    ti = batch_ti;
    pending = mask;
    while (pending && fetched - consumed < kRing) start_copy();
  }
  __device__ const float* acquire() {
    const int b = consumed % kRing;
    mbar_wait(bar + b, (uint32_t)((consumed / kRing) & 1));
    ++consumed;
    return buf + b * tile_floats();
  }
  // after the barrier that ends the scan: the buffer just read takes the next copy
  __device__ void release() {
    if (pending) start_copy();
  }
  __device__ void drain() {
    for (; consumed < fetched; ++consumed)
      mbar_wait(bar + consumed % kRing, (uint32_t)((consumed / kRing) & 1));
  }
};

__global__ void __launch_bounds__(kGroupThreads)
closest_hit_pipe_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                        const float* __restrict__ aabb, const int* __restrict__ order,
                        float* __restrict__ out_t, int* __restrict__ out_slot,
                        int* __restrict__ out_counts, long long* __restrict__ out_cycles,
                        int n_tiles, int tile) {
  extern __shared__ __align__(128) float s_buf[];  // (kRing, 10, tile)
  __shared__ WalkShared s;
  __shared__ __align__(8) uint64_t s_bar[kRing];
  if (threadIdx.x == 0) {
    for (int b = 0; b < kRing; ++b) mbar_init(s_bar + b);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  RingStager st{s_buf, s_bar, tris, tile, nullptr, 0u, 0, 0};
  group_walk(rays, aabb, order, out_t, out_slot, out_counts, out_cycles, n_tiles, tile, s, st);
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
