// The closest-hit query's finish for Hopper (sm_90a), one thread a ray: for
// each sorted position i, the tile kernel's (best_t, slot) of row i scattered
// to the caller's ray j = perm[i] (ray i without a permutation) as
// `closest_hit._finish` and the inverse permutation's gathers leave them
// (t = +inf on a miss, slot, hit = slot >= 0), with `trace.winner_bary`'s
// barycentrics of the winning triangle (0 on a miss).  A live ray's packed
// origin and direction are the caller's own, so they are read from the
// packed row; a dead ray never hits.  A ray reads 8 B of the permutation,
// 8 B of the kernel's outputs, 24 B of its row and, on a hit, the winner's
// 36 B of vertices from the attr rows (972 rows on the main path: they stay
// in L2); it writes 21 B.  See query_math.cuh.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "query_math.cuh"

namespace {

struct Args {
  const long long* perm;                   // (R,) int64, or null: the identity
  const float* t_in;                       // (R_pad,) the tile kernel's best t
  const int* slot_in;                      // (R_pad,) its slot, -1 on a miss
  const float* rays;                       // (R_pad, 8) the packed rows
  const float* attr; long long attr_s[2];  // (T, 26) vertices in columns 0:9
  float* t;                                // (R,)
  int* slot;                               // (R,)
  unsigned char* hit;                      // (R,) bool
  float* bary;                             // (R, 3)
  long long n_rays;
};
static_assert(sizeof(Args) / 8 == 12, "trace._FINISH_SLOTS");

__global__ void __launch_bounds__(kThreads) query_finish_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_rays) return;
  const long long j = a.perm != nullptr ? a.perm[i] : i;
  const int slot = a.slot_in[i];
  const bool hit = slot >= 0;
  float bary[3] = {0.0f, 0.0f, 0.0f};
  if (hit) {
    const float4* row = reinterpret_cast<const float4*>(a.rays + 8 * i);
    const float4 lo = row[0], hi = row[1];
    const Ray ray = {{lo.x, lo.y, lo.z}, {lo.w, hi.x, hi.y}};
    const float* src = a.attr + (long long)slot * a.attr_s[0];
    float tri[9];
    for (int k = 0; k < 9; ++k) tri[k] = src[k * a.attr_s[1]];
    winner_bary(ray, tri, bary);
  }
  a.t[j] = hit ? a.t_in[i] : __int_as_float(0x7f800000);
  a.slot[j] = slot;
  a.hit[j] = hit;
  a.bary[3 * j] = bary[0];
  a.bary[3 * j + 1] = bary[1];
  a.bary[3 * j + 2] = bary[2];
}

}  // namespace

// C entry point, loaded with ctypes.  `args` is the host copy of the kernel's
// argument block (`Args`).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); refuses an unaligned row buffer.
extern "C" int gpt_query_finish(const long long* args, void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.n_rays < 0 || reinterpret_cast<uintptr_t>(a.rays) % 16) return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const long long blocks = (a.n_rays + kThreads - 1) / kThreads;
  query_finish_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
