// The ring of tile buffers that the ring-buffered kernels share:
// closest_hit_pipe.cu and anyhit_pipe.cu (one operand a tile: the
// triangles) and closest_hit_mxu.cu (three: the triangles, the margin scales
// and the edge weights).  A `Stager` of `group_walk` (closest_hit_common.cuh): the batch's
// vote names its candidate tiles before any is scanned, so the copies of the
// first `Ring` candidates start at once, and the copy of candidate i + Ring as
// soon as the group is done with candidate i's buffer.
//
// RingStager fills a buffer with Tensor Memory Accelerator bulk copies
// (cp.async.bulk), one per operand, all issued by one thread and completing
// on the buffer's mbarrier, whose expected transaction count is their sum.
// Buffer b's mbarrier completes one phase per fill, so candidate n (counted
// over the whole walk) waits for parity (n / Ring) & 1 of buffer n % Ring.
// CpAsyncStager is the same ring filled with 16-byte cp.async copies by every
// thread (one commit group per fill, a barrier before the buffer is read);
// closest_hit_mxu.cu keeps it as the measured alternative.
//
// A candidate whose early-exit re-check fails ends the walk with up to Ring
// copies in flight; drain() waits for all of them before the group leaves.

#pragma once

#include <cstdint>

#include "closest_hit_common.cuh"

namespace gpt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The N operands of a tile: operand i of tile ti is bytes[i] bytes at
// src[i] + ti * bytes[i]; a buffer holds them one after another.  Every size
// and address is a multiple of 16 bytes (the caller checks).
template <int N>
struct TileOperands {
  const char* src[N];
  uint32_t bytes[N];
};

template <int N>
__device__ __forceinline__ uint32_t operand_bytes(const TileOperands<N>& ops) {
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) total += ops.bytes[i];
  return total;
}

// Keeps up to Ring candidate tiles in flight with TMA bulk copies.  Every
// thread tracks the same counters; thread 0 starts the copies.  The kernel
// calls init() and then __syncthreads() before the walk.
template <int Ring, int N>
struct RingStager {
  char* buf;      // (Ring, buf_bytes)
  uint64_t* bar;  // (Ring)
  TileOperands<N> ops;
  uint32_t buf_bytes;
  const int* ti = nullptr;
  unsigned pending = 0u;  // candidates of the batch whose copy has not started
  int fetched = 0;        // copies started over the walk
  int consumed = 0;       // candidates acquired over the walk

  __device__ RingStager(void* buf_, uint64_t* bar_, const TileOperands<N>& ops_)
      : buf(static_cast<char*>(buf_)), bar(bar_), ops(ops_), buf_bytes(operand_bytes(ops_)) {}

  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int b = 0; b < Ring; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar + b))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __device__ void start_copy() {
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    if (threadIdx.x == 0) {
      const int b = fetched % Ring;
      char* dst = buf + b * buf_bytes;
      // the buffer was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(bar + b)), "r"(buf_bytes)
                   : "memory");
#pragma unroll
      for (int i = 0; i < N; ++i) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];"
            ::"r"(smem_addr(dst)), "l"(ops.src[i] + (long long)ti[k] * ops.bytes[i]),
            "r"(ops.bytes[i]), "r"(smem_addr(bar + b))
            : "memory");
        dst += ops.bytes[i];
      }
    }
    ++fetched;
  }
  __device__ void begin_batch(const int* batch_ti, unsigned mask) {
    ti = batch_ti;
    pending = mask;
    while (pending && fetched - consumed < Ring) start_copy();
  }
  __device__ const float* acquire() {
    const int b = consumed % Ring;
    mbar_wait(bar + b, (uint32_t)((consumed / Ring) & 1));
    ++consumed;
    return reinterpret_cast<const float*>(buf + b * buf_bytes);
  }
  // after the barrier that ends the scan: the buffer just read takes the next copy
  __device__ void release() {
    if (pending) start_copy();
  }
  __device__ void drain() {
    for (; consumed < fetched; ++consumed)
      mbar_wait(bar + consumed % Ring, (uint32_t)((consumed / Ring) & 1));
  }
};

// The same ring filled with cp.async: every thread copies its 16-byte chunks
// of a fill and commits them as one group; acquire() waits for the oldest
// group and then for every other thread's chunks (one barrier).
template <int Ring, int N>
struct CpAsyncStager {
  char* buf;
  TileOperands<N> ops;
  uint32_t buf_bytes;
  const int* ti = nullptr;
  unsigned pending = 0u;
  int fetched = 0;
  int consumed = 0;

  __device__ CpAsyncStager(void* buf_, uint64_t*, const TileOperands<N>& ops_)
      : buf(static_cast<char*>(buf_)), ops(ops_), buf_bytes(operand_bytes(ops_)) {}

  __device__ void init() {}
  __device__ void start_copy() {
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    char* dst = buf + (fetched % Ring) * buf_bytes;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const char* src = ops.src[i] + (long long)ti[k] * ops.bytes[i];
      for (uint32_t j = 16u * threadIdx.x; j < ops.bytes[i]; j += 16u * kGroupThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + j)),
                     "l"(src + j)
                     : "memory");
      dst += ops.bytes[i];
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    ++fetched;
  }
  __device__ void begin_batch(const int* batch_ti, unsigned mask) {
    ti = batch_ti;
    pending = mask;
    while (pending && fetched - consumed < Ring) start_copy();
  }
  __device__ const float* acquire() {
    // the groups after the oldest may stay in flight (at most one is waited
    // past, which holds for Ring <= 2 and is merely stricter above)
    if (fetched - consumed > 1)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const int b = consumed % Ring;
    ++consumed;
    return reinterpret_cast<const float*>(buf + b * buf_bytes);
  }
  __device__ void release() {
    if (pending) start_copy();
  }
  __device__ void drain() {
    asm volatile("cp.async.wait_all;" ::: "memory");
    consumed = fetched;
  }
};

}  // namespace gpt
