// The closest-hit query's coherence key for Hopper (sm_90a), one thread a ray:
// `trace.coherence_perm`'s (morton << 3) | octant key of the ray as
// `trace.park_dead` parks it, with 1 << 21 for a dead ray, written as int32
// (it fits in 22 bits) for `torch.sort(key, stable=True)`, which then gives
// the permutation of the int64 key and runs half its radix passes.
// A ray reads 24 B and its live flag and writes 4 B.  See query_math.cuh.

#include <cuda_runtime.h>

#include <cstring>

#include "query_math.cuh"

namespace {

// The argument block: every field 8 bytes, filled by the wrapper as one
// int64 array.  Strides are in elements.
struct Args {
  const float* origin; long long origin_s[2];  // (R, 3)
  const float* dir; long long dir_s[2];        // (R, 3)
  const unsigned char* live; long long live_s;  // (R,) bool, or null: every ray live
  const float* root;                            // (3, 3) `trace.root_box`
  int* key;                                     // (R,)
  long long n_rays;
};
static_assert(sizeof(Args) / 8 == 11, "trace._KEY_SLOTS");

__global__ void __launch_bounds__(kThreads) query_key_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_rays) return;
  const Root root = load_root(a.root);
  bool alive;
  const Ray ray = load_ray(a.origin, a.origin_s, a.dir, a.dir_s, a.live, a.live_s, i, root, &alive);
  a.key[i] = coherence_key(ray, root, alive);
}

}  // namespace

// C entry point, loaded with ctypes.  `args` is the host copy of the kernel's
// argument block (`Args`).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gpt_query_key(const long long* args, void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.n_rays < 0) return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const long long blocks = (a.n_rays + kThreads - 1) / kThreads;
  query_key_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
