// Ring-buffered closest-hit tile kernel with a tensor-core edge prefilter,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel_big_pipe_mxu`
// (gpu_pathtracer_tpu/ops/pallas_trace.py, pair compute `_pair_compute_mxu`,
// packer `pack_edge_cols`): the query, layouts, exact pair test and walk of
// closest_hit_pipe.cu (the group walk of closest_hit_common.cuh, the TMA
// ring of tile_ring.cuh), with a cheap conservative test in front of the
// exact one.  For every (ray, triangle) pair the three Pluecker edge values
//     e_m = d . cross(a, b) + (o x d) . (b - a),   (a, b) = (v1,v2) (v2,v3) (v3,v1)
// come out of one bf16 matrix product with f32 accumulation, edge weights
// (3 * 128, 8) x the group's rays (8, 8), computed HERE with warp-level
// tensor-core instructions (mma.sync.aligned.m16n8k8, bf16 in, f32 out).  A
// triangle can only be hit if its three values share a sign.  A pair is a
// candidate when they do within the margin 2^-6 * rmax_i * wsum_j (rmax_i =
// max |[d, o x d]| of the ray in f32, wsum_j = sum |w| * (1 + 2^-7) of the
// edge row, -1 for invalid and padding triangles so that their all-zero rows
// are never candidates) and the ray is live (best_t > 0 at the tile's
// start).  The margin covers the bf16 rounding of both factors with a factor
// of two to spare, so no pair that the exact test accepts is ever culled:
// (t, slot) equal closest_hit_pipe.cu's bit for bit, and since the walk is
// the same, so do the walked, fetched and scanned counts, group by group.
//
// The product: the edge rows are the M operand (16 triangle-edge rows, k = 8,
// row major) and the group's 8 rays the N operand (N = 8 = kGroupRays).
// Fragments (lane = 4 g + t): A holds rows g and g + 8 at k = 2t, 2t + 1, one
// conflict-free 32-bit shared-memory load each from the (384, 8) bf16 edge
// tile; B holds k = 2t, 2t + 1 of ray g, one register for the whole walk; C
// holds rows g, g + 8 for rays 2t, 2t + 1.  The three edges of triangle j are
// rows j, 128 + j and 256 + j, so running each 16-triangle block of the three
// edges through the same accumulator positions leaves all three values of a
// pair in one thread: 24 mma for a tile and a group.
//
// Build-time choices (scripts/sweep_closest_hit_walk.py --sweep times every
// combination; the committed one was the fastest or within 3% of it at mesh
// bounce 0 and bounce 2 on an H100):
//   kPerRay    0: the union of the candidates over the group's 8 rays, one
//              128-bit mask a tile; 1: each ray's own mask (a warp's 4 rays
//              run as long as the longest of them);
//   kSplitMma  0: each warp computes the whole product (no barrier); 1: each
//              computes half of the triangles and the masks meet in shared
//              memory (one barrier);
//   kCpAsync   0: the ring filled by TMA bulk copies; 1: by cp.async;
//   kRing      tile buffers in flight, B2's depth (the same fetched counts):
//              a buffer is 12,800 B, and one of them lets an SM hold ~12
//              groups against ~7 with two, which the bounce-0 wavefront's
//              throughput needs more than the fetch ahead.
// Either mask is compacted into the ray's list of candidate columns in
// rising order, and thread p of a ray tests entries p, p + 8, ...: with
// strict `<` and ray_min that is the first column at the minimum t, as in
// the full scan.
//
// Layout beyond closest_hit_common.cuh's (packed by
// gpu_pathtracer_tpu_torch/ops/closest_hit.py, `pack_edge_tiles`):
//   edges (NT, 3 * 128, 8)  bf16  per edge row [cross(a, b), b - a, 0, 0]
//   wsum  (NT, 3, 128)      f32   margin scale per edge row, -1 = never a candidate
// A ring buffer holds a tile's triangles (5,120 B), margin scales (1,536 B)
// and edge weights (6,144 B): three bulk copies on one mbarrier.
//
// What bounds it on this card: as closest_hit_pipe.cu, the slowest group's
// scans of the tiles that survive the walk's cull.  The prefilter trades a
// tile's 8 x 128 exact pair tests (~42 fp32 operations each) for 24 mma,
// 3,072 threshold tests and the exact tests of the surviving columns.

#include <cuda_bf16.h>

#include <type_traits>

#include "closest_hit_common.cuh"
#include "tile_ring.cuh"

using namespace gpt;

namespace {

constexpr int kTile = 128;                        // triangles per tile, fixed
constexpr int kK = 8;                             // contraction depth of m16n8k8
constexpr uint32_t kTriBytes = kTileRows * kTile * 4;  // 5,120
constexpr uint32_t kWsumBytes = 3 * kTile * 4;         // 1,536
constexpr uint32_t kEdgeBytes = 3 * kTile * kK * 2;    // 6,144
constexpr float kMargin = 0.015625f;              // 2^-6
constexpr int kRing = 1;
constexpr int kPerRay = 0;
constexpr int kSplitMma = 1;
constexpr int kCpAsync = 0;
constexpr int kWords = kTile / 32;  // a 128-column mask
constexpr int kMyBlocks = (kSplitMma ? kTile / kGroupWarps : kTile) / 16;  // 16-row blocks a warp multiplies
constexpr int kMyWords = kMyBlocks / 2;
static_assert(kGroupRays == 8, "the group's rays are the N = 8 operand of m16n8k8");
static_assert(kRayThreads * 16 == kTile, "each of a ray's threads lists 16 columns");
static_assert(kGroupWarps == 2, "the product splits over two warps");

using Stager = std::conditional_t<kCpAsync != 0, CpAsyncStager<kRing, 3>, RingStager<kRing, 3>>;

__device__ __forceinline__ void mma_m16n8k8_bf16(float (&c)[4], unsigned a0, unsigned a1,
                                                 unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// A ray's side of the product, [d, o x d, 0, 0] in f32 (o x d in the plain
// version's expression order); returns rmax = max |.| of its six values.
__device__ __forceinline__ float ray_row(const float* __restrict__ r, float (&v)[kK]) {
  const float ox = r[0], oy = r[1], oz = r[2], dx = r[3], dy = r[4], dz = r[5];
  v[0] = dx;
  v[1] = dy;
  v[2] = dz;
  v[3] = oy * dz - oz * dy;
  v[4] = oz * dx - ox * dz;
  v[5] = ox * dy - oy * dx;
  v[6] = v[7] = 0.0f;
  float rmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) rmax = fmaxf(rmax, fabsf(v[k]));
  return rmax;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

struct PrefilterShared {
  float best[2][kGroupRays];               // each ray's best t at a scan's start, by scan parity
  unsigned mask[kGroupRays][kWords];       // the masks the warps exchange (kSplitMma)
  unsigned char list[kGroupRays][kTile + 4];  // each ray's candidate columns (padded: no bank clash)
  int passed[kGroupWarps];
};

// The Scan of group_walk with the prefilter in front of the exact test.
struct PrefilterScan : ClosestHit {
  static constexpr int kCounts = 2;  // pairs passed to the exact test, pairs culled
  PrefilterShared& s;
  unsigned b0;     // B fragment: k = 2t, 2t + 1 of ray g
  float mr[2];     // 2^-6 rmax of rays 2t, 2t + 1
  int n = 0;       // tiles scanned so far (the parity of s.best)
  int passed = 0;  // pairs passed: the group's (union) or this ray's (per ray)

  // Before group_walk, whose first barrier publishes s.best[0].
  __device__ PrefilterScan(PrefilterShared& s_, const float* __restrict__ rays, float* out_t,
                           int* out_slot)
      : ClosestHit(out_t, out_slot), s(s_) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* group = rays + (long long)blockIdx.x * kGroupRays * 8;
    float v[kK];
    ray_row(group + g * 8, v);
    b0 = t == 0 ? bf16x2(v[0], v[1])
                : (t == 1 ? bf16x2(v[2], v[3]) : (t == 2 ? bf16x2(v[4], v[5]) : bf16x2(v[6], v[7])));
    mr[0] = kMargin * ray_row(group + 2 * t * 8, v);
    mr[1] = kMargin * ray_row(group + (2 * t + 1) * 8, v);
    const int r = threadIdx.x / kRayThreads;
    if (threadIdx.x % kRayThreads == 0) s.best[0][r] = fminf(kInf, group[r * 8 + 6]);
  }

  __device__ void scan(const float* __restrict__ buf, int, int part, const Ray& q, int base) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
    const int r = threadIdx.x / kRayThreads;
    const float* s_wsum = buf + kTriBytes / 4;
    const unsigned* s_edge = reinterpret_cast<const unsigned*>(buf + (kTriBytes + kWsumBytes) / 4);

    // this thread's pairs: triangles j, j + 8 of each of the warp's blocks
    // (word qb / 2, bits 16 (qb % 2) + g and + 8) for rays 2t (w0), 2t + 1 (w1)
    unsigned w0[kMyWords], w1[kMyWords];
    const int tri0 = kSplitMma ? warp * (kTile / kGroupWarps) : 0;
#pragma unroll
    for (int qb = 0; qb < kMyBlocks; ++qb) {
      const int j = tri0 + 16 * qb + g;
      bool pos[4] = {true, true, true, true}, neg[4] = {true, true, true, true};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int row = m * kTile + j;
        float e[4];
        mma_m16n8k8_bf16(e, s_edge[row * (kK / 2) + t4], s_edge[(row + 8) * (kK / 2) + t4], b0);
        const float ws_lo = s_wsum[row], ws_hi = s_wsum[row + 8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // (j, 2t) (j, 2t + 1) (j + 8, 2t) (j + 8, 2t + 1)
          const float margin = mr[i & 1] * (i < 2 ? ws_lo : ws_hi);
          pos[i] = pos[i] && (e[i] >= -margin);
          neg[i] = neg[i] && (e[i] <= margin);
        }
      }
      const int bit = 16 * (qb & 1) + g;
      const unsigned c0 = ((unsigned)(pos[0] || neg[0]) << bit) |
                          ((unsigned)(pos[2] || neg[2]) << (bit + 8));
      const unsigned c1 = ((unsigned)(pos[1] || neg[1]) << bit) |
                          ((unsigned)(pos[3] || neg[3]) << (bit + 8));
      w0[qb >> 1] = (qb & 1) ? (w0[qb >> 1] | c0) : c0;
      w1[qb >> 1] = (qb & 1) ? (w1[qb >> 1] | c1) : c1;
    }
    const unsigned live0 = s.best[n & 1][2 * t4] > 0.0f ? kFull : 0u;
    const unsigned live1 = s.best[n & 1][2 * t4 + 1] > 0.0f ? kFull : 0u;
#pragma unroll
    for (int i = 0; i < kMyWords; ++i) {
      w0[i] &= live0;
      w1[i] &= live1;
    }

    // the ray's 128-bit mask
    unsigned mk[kWords];
    if (kPerRay == 0) {
      unsigned u[kMyWords];
#pragma unroll
      for (int i = 0; i < kMyWords; ++i) u[i] = __reduce_or_sync(kFull, w0[i] | w1[i]);
      if (kSplitMma) {
        if (lane == 0)
          for (int i = 0; i < kMyWords; ++i) s.mask[0][warp * kMyWords + i] = u[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kWords; ++i) mk[i] = s.mask[0][i];
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) mk[i] = u[i % kMyWords];
      }
    } else {
      // OR over the 8 lanes of each t: lane t then holds rays 2t and 2t + 1
#pragma unroll
      for (int i = 0; i < kMyWords; ++i)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          w0[i] |= __shfl_xor_sync(kFull, w0[i], off);
          w1[i] |= __shfl_xor_sync(kFull, w1[i], off);
        }
      if (kSplitMma) {
        if (g == 0)
          for (int i = 0; i < kMyWords; ++i) {
            s.mask[2 * t4][warp * kMyWords + i] = w0[i];
            s.mask[2 * t4 + 1][warp * kMyWords + i] = w1[i];
          }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kWords; ++i) mk[i] = s.mask[r][i];
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          const unsigned a = __shfl_sync(kFull, w0[i % kMyWords], (r >> 1) & 3);
          const unsigned b = __shfl_sync(kFull, w1[i % kMyWords], (r >> 1) & 3);
          mk[i] = (r & 1) ? b : a;
        }
      }
    }

    // the ray's list of candidate columns, rising: thread `part` lists
    // columns 16 part .. 16 part + 15
    int n_cand = 0, at = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      n_cand += __popc(mk[i]);
      if (2 * i + 1 < part) at += __popc(mk[i]);
    }
    const unsigned word = part < 2 ? mk[0] : (part < 4 ? mk[1] : (part < 6 ? mk[2] : mk[3]));
    unsigned bits = word & 0xffffu;
    if (part & 1) {
      at += __popc(bits);
      bits = word >> 16;
    }
    unsigned char* list = s.list[r];
    while (bits) {
      list[at++] = (unsigned char)(16 * part + __ffs(bits) - 1);
      bits &= bits - 1;
    }
    __syncwarp();

    float bt = best_t;
    int bc = -1;
    for (int k = part; k < n_cand; k += kRayThreads) {
      const int c = list[k];
      float t;
      if (woop_pair(buf, kTile, c, q, t) && t < bt && t <= q.t_cap) {
        bt = t;
        bc = c;
      }
    }
    ray_min(bt, bc);
    take(bt, bc, base);
    if (part == 0) s.best[(n + 1) & 1][r] = bt;
    ++n;
    passed += kPerRay ? n_cand : n_cand * kGroupRays;
  }

  __device__ void count(int* out, int scanned) {
    int total = passed;
    if (kPerRay) {
      const int sum = __reduce_add_sync(kFull, threadIdx.x % kRayThreads == 0 ? passed : 0);
      if ((threadIdx.x & 31) == 0) s.passed[threadIdx.x >> 5] = sum;
      __syncthreads();
      total = 0;
      for (int w = 0; w < kGroupWarps; ++w) total += s.passed[w];
    }
    if (threadIdx.x == 0) {
      out[0] = total;
      out[1] = scanned * kGroupRays * kTile - total;
    }
  }
};

__global__ void __launch_bounds__(kGroupThreads)
closest_hit_mxu_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                       const float* __restrict__ aabb, const int* __restrict__ order,
                       const void* __restrict__ edges, const float* __restrict__ wsum,
                       float* __restrict__ out_t, int* __restrict__ out_slot,
                       int* __restrict__ out_counts, long long* __restrict__ out_cycles,
                       int n_tiles) {
  extern __shared__ __align__(128) float s_buf[];  // (kRing, 12,800 B)
  __shared__ WalkShared s;
  __shared__ PrefilterShared ps;
  __shared__ __align__(8) uint64_t s_bar[kRing];
  const TileOperands<3> ops{{reinterpret_cast<const char*>(tris),
                             reinterpret_cast<const char*>(wsum),
                             static_cast<const char*>(edges)},
                            {kTriBytes, kWsumBytes, kEdgeBytes}};
  Stager st(s_buf, s_bar, ops);
  st.init();
  PrefilterScan sc(ps, rays, out_t, out_slot);
  __syncthreads();
  group_walk(blockIdx.x, rays, aabb, order, out_counts, out_cycles, n_tiles, kTile, s, st, sc);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / kGroupRays, 5)
// int32: per group the order entries walked, the tiles fetched, the tiles
// scanned, the (ray, triangle) pairs of the scanned tiles that went through
// the exact test and those that the prefilter culled; `out_cycles` is null or
// (n_rays / kGroupRays, 2) int64: per group the clock64 cycles of the walk and
// of its waiting, prefiltering and scanning.
extern "C" int gpt_closest_hit_mxu(const float* rays, const float* tris, const float* aabb,
                                   const int* order, const void* edges, const float* wsum,
                                   float* out_t, int* out_slot, int* out_counts,
                                   long long* out_cycles, int n_rays, int n_tiles, int tile,
                                   void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile != kTile ||
      reinterpret_cast<size_t>(tris) % 16 != 0 || reinterpret_cast<size_t>(aabb) % 16 != 0 ||
      reinterpret_cast<size_t>(edges) % 16 != 0 || reinterpret_cast<size_t>(wsum) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)kRing * (kTriBytes + kWsumBytes + kEdgeBytes);
  closest_hit_mxu_kernel<<<n_rays / kGroupRays, kGroupThreads, smem, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, edges, wsum, out_t, out_slot, out_counts, out_cycles, n_tiles);
  return (int)cudaGetLastError();
}
