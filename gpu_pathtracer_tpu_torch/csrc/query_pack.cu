// The closest-hit query's ray pack for Hopper (sm_90a), one thread a row:
// for each sorted position i, ray perm[i] of the caller (ray i without a
// permutation), parked if dead (`trace.park_dead`), as the tile kernels read
// it: the (R_pad, 8) row [o, d, t_cap, 0] of `closest_hit.prepare_rays`, its
// budget t_cap `root_exit_cap`'s with t_max for a live ray and -1 for a dead
// one; rows R..R_pad-1 are prepare_rays' padding, d = +z with a budget of 0.
// A row reads 8 B of the permutation and gathers 24 B and a live flag; it
// writes 32 B.  See query_math.cuh.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "query_math.cuh"

namespace {

struct Args {
  const long long* perm;                        // (R,) int64, or null: the identity
  const float* origin; long long origin_s[2];   // (R, 3)
  const float* dir; long long dir_s[2];         // (R, 3)
  const unsigned char* live; long long live_s;  // (R,) bool, or null: every ray live
  const float* root;                            // (3, 3) `trace.root_box`
  float* rays;                                  // (R_pad, 8)
  long long n_rays, n_pad;
};
static_assert(sizeof(Args) / 8 == 13, "trace._PACK_SLOTS");

__global__ void __launch_bounds__(kThreads) query_pack_kernel(const Args a, float t_max) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_pad) return;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 hi = make_float4(0.0f, 1.0f, 0.0f, 0.0f);
  if (i < a.n_rays) {
    const Root root = load_root(a.root);
    const long long j = a.perm != nullptr ? a.perm[i] : i;
    bool alive;
    const Ray ray =
        load_ray(a.origin, a.origin_s, a.dir, a.dir_s, a.live, a.live_s, j, root, &alive);
    const float cap = root_exit_cap(ray, root, alive ? t_max : -1.0f);
    lo = make_float4(ray.o[0], ray.o[1], ray.o[2], ray.d[0]);
    hi = make_float4(ray.d[1], ray.d[2], cap, 0.0f);
  }
  float4* row = reinterpret_cast<float4*>(a.rays + 8 * i);
  row[0] = lo;
  row[1] = hi;
}

}  // namespace

// C entry point, loaded with ctypes.  `args` is the host copy of the kernel's
// argument block (`Args`), `t_max` every live ray's budget.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched); refuses a padded
// count below the rays' or an unaligned row buffer.
extern "C" int gpt_query_pack(const long long* args, float t_max, void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.n_rays < 0 || a.n_pad < a.n_rays || reinterpret_cast<uintptr_t>(a.rays) % 16)
    return (int)cudaErrorInvalidValue;
  if (a.n_pad == 0) return 0;
  const long long blocks = (a.n_pad + kThreads - 1) / kThreads;
  query_pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, t_max);
  return (int)cudaGetLastError();
}
