// Double-buffered closest-hit tile kernel with a tensor-core edge prefilter,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_closest_kernel_big_pipe_mxu`
// (gpu_pathtracer_tpu/ops/pallas_trace.py, pair compute `_pair_compute_mxu`,
// packer `pack_edge_cols`): the query, walk, layouts and exact pair test of
// closest_hit_pipe.cu (closest_hit_common.cuh), with a cheap conservative
// test in front of the exact one.  For every (ray, triangle) pair the three
// Pluecker edge values
//     e_m = d . cross(a, b) + (o x d) . (b - a),   (a, b) = (v1,v2) (v2,v3) (v3,v1)
// come out of one bf16 matrix product with f32 accumulation, rays (128, 8) x
// edge weights (8, 3 * 128), computed HERE with warp-level tensor-core
// instructions (mma.sync.aligned.m16n8k8, bf16 in, f32 out).  A triangle can
// only be hit if its three values share a sign.  A pair is a candidate when
// they do within the margin 2^-6 * rmax_i * wsum_j (rmax_i = max |[d, o x d]|
// of the ray in f32, wsum_j = sum |w| * (1 + 2^-7) of the edge column, -1 for
// invalid and padding triangles so that their all-zero columns are never
// candidates) and the ray is live (best_t > 0).  The margin covers the bf16
// rounding of both factors with a factor of two to spare, so no pair that the
// exact test accepts is ever culled, and (t, slot) equal closest_hit_pipe.cu's
// and closest_hit.cu's bit for bit.
//
// Granularity of the cull: the union of the candidates over a WARP's 32 rays,
// one bit per triangle column, made and consumed 32 columns (one register
// word) at a time.  A warp is what executes: a column that any of its lanes
// needs costs all 32 lanes a scheduler slot whether the others are masked or
// not, so a per-ray mask would save no time.  The union comes from warp ballots over the accumulator
// fragments, so the candidate bits never go through shared memory, need no
// atomics and no barrier, and the scan's shared-memory reads of the triangle
// columns stay warp-wide broadcasts.  The TPU kernel's vote over 128-lane
// sub-tiles of a 2048-triangle tile has no counterpart at 128-triangle tiles.
// Testing a non-candidate pair of the union is harmless: the exact test
// rejects it.
//
// Fragments (m16n8k8, lane = 4 * g + t): A holds rows g and g + 8 of a
// 16-ray block, k = 2t, 2t + 1; B holds k = 2t, 2t + 1 of column g; C holds
// rows g, g + 8 and columns 2t, 2t + 1.  The three edges of triangle j are
// columns j, 128 + j and 256 + j, so running the same 8-column block of each
// edge through the same accumulator positions leaves all three values of a
// pair in one thread.  The edge tile is stored column-major, (384, 8) bf16,
// so a B fragment is one conflict-free 32-bit shared-memory load.
//
// Layout beyond closest_hit_common.cuh's (packed by
// gpu_pathtracer_tpu_torch/ops/closest_hit.py, `pack_edge_tiles`):
//   edges (NT, 3 * 128, 8)  bf16  per column [cross(a, b), b - a, 0, 0]
//   wsum  (NT, 3, 128)      f32   margin scale per column, -1 = never a candidate
// Both are copied beside the triangle tile in the same cp.async commit group.
//
// What bounds it on this card: as closest_hit_pipe.cu, the per-tile walk and
// the fp32 pair tests of the scanned tiles, and a launch lasts as long as its
// slowest block.  The product is 96 mma a warp and tile, negligible; the
// threshold arithmetic on the accumulators is about a fifth of a full tile
// scan; and the scan of the surviving columns has no fixed trip count, so it
// tests kScanWide columns together to overlap their shared-memory loads
// (scripts/sweep_closest_hit_mxu.py sweeps that width).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "closest_hit_common.cuh"

using namespace gpt;

namespace {

constexpr int kTile = 128;                        // triangles per tile, fixed
constexpr int kK = 8;                             // contraction depth of m16n8k8
constexpr int kTriFloats = kTileRows * kTile;     // 1280
constexpr int kWsumFloats = 3 * kTile;            // 384
constexpr int kEdgeFloats = 3 * kTile * kK / 2;   // 3072 bf16 = 1536 floats
constexpr int kBufFloats = kTriFloats + kWsumFloats + kEdgeFloats;  // 3200 = 12,800 B
constexpr float kMargin = 0.015625f;              // 2^-6
constexpr int kScanWide = 4;                      // candidate columns tested together

__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src,
                                           int n_chunks) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n_chunks; i += kBlock)
    __pipeline_memcpy_async(d + i, s + i, sizeof(float4));
}

// Start this thread's share of the copies of tile `ti` (triangles, margin
// scales, edge weights) into one buffer.
__device__ __forceinline__ void stage_async(float* buf, const float* __restrict__ tris,
                                            const float* __restrict__ wsum,
                                            const __nv_bfloat16* __restrict__ edges, int ti) {
  copy_async(buf, tris + (long long)ti * kTriFloats, kTriFloats / 4);
  copy_async(buf + kTriFloats, wsum + (long long)ti * kWsumFloats, kWsumFloats / 4);
  copy_async(buf + kTriFloats + kWsumFloats,
             reinterpret_cast<const float*>(edges) + (long long)ti * kEdgeFloats,
             kEdgeFloats / 4);
}

__device__ __forceinline__ void mma_m16n8k8_bf16(float (&c)[4], unsigned a0, unsigned a1,
                                                 unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// The warp's candidate columns among 32 consecutive triangle columns (word
// `w`) of one staged tile: bit c is set when some live ray of the warp has
// sign-consistent edge values within the margin for column 32 w + c.
// Warp-uniform.  `a` are this thread's A fragments of the warp's two 16-ray
// blocks, `mr` = 2^-6 * rmax of its four accumulator rows (g, g + 8, 16 + g,
// 24 + g), `live` bit r set when row r's ray is live.
__device__ __forceinline__ unsigned candidate_word(const float* __restrict__ s_wsum,
                                                   const unsigned* __restrict__ s_edge, int w,
                                                   const unsigned (&a)[2][2],
                                                   const float (&mr)[4], unsigned live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned word = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // four 8-column blocks
    // pos / neg per (row, column) of this thread's accumulator positions:
    // index 4 * block + 2 * (row half) + (column parity)
    bool pos[8], neg[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pos[i] = neg[i] = true;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int col = m * kTile + w * 32 + q * 8;
      const unsigned b0 = s_edge[(col + g) * (kK / 2) + t];
      const float2 ws = *reinterpret_cast<const float2*>(s_wsum + col + 2 * t);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        float e[4];
        mma_m16n8k8_bf16(e, a[mb][0], a[mb][1], b0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float margin = mr[2 * mb + (i >> 1)] * ((i & 1) ? ws.y : ws.x);
          pos[4 * mb + i] = pos[4 * mb + i] && (e[i] >= -margin);
          neg[4 * mb + i] = neg[4 * mb + i] && (e[i] <= margin);
        }
      }
    }
    bool even = false, odd = false;  // columns 2t and 2t + 1, any of this thread's live rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool cand = (pos[i] || neg[i]) && ((live >> (i >> 1)) & 1u);
      if (i & 1) odd = odd || cand; else even = even || cand;
    }
    const unsigned be = __ballot_sync(kFull, even), bo = __ballot_sync(kFull, odd);
    unsigned bits = 0u;  // the eight columns of this block
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (be & (0x11111111u << tt)) bits |= 1u << (2 * tt);
      if (bo & (0x11111111u << tt)) bits |= 1u << (2 * tt + 1);
    }
    word |= bits << (q * 8);
  }
  return word;
}

// One staged tile (`buf`: triangles, margin scales, edge weights) against
// this thread's ray: 32 columns at a time, the warp's candidate columns, then
// the exact test on them in column order.  Liveness is taken from the best_t
// the tile starts with.  Returns the number of pairs the warp's 32 rays put
// through the exact test.
__device__ __forceinline__ int scan_tile_prefiltered(const float* __restrict__ buf, int base,
                                                  const Ray& q, const unsigned (&a)[2][2],
                                                  const float (&mr)[4], float& best_t,
                                                  int& best_slot) {
  const int g = (threadIdx.x & 31) >> 2;
  unsigned live = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (__shfl_sync(kFull, best_t, (i >> 1) * 16 + g + (i & 1) * 8) > 0.0f) live |= 1u << i;
  const float* s_wsum = buf + kTriFloats;
  const unsigned* s_edge = reinterpret_cast<const unsigned*>(buf + kTriFloats + kWsumFloats);
  int passed = 0;
#pragma unroll 1
  for (int w = 0; w < kTile / 32; ++w) {
    unsigned m = candidate_word(s_wsum, s_edge, w, a, mr, live);
    passed += __popc(m) * 32;
    // kScanWide candidate columns at a time: their pair tests are independent,
    // so their shared-memory loads overlap; the results are applied in
    // column order (a slot past the last candidate repeats column 0, unused)
    while (m) {
      int c[kScanWide];
      bool has[kScanWide], ok[kScanWide];
      float t[kScanWide];
#pragma unroll
      for (int i = 0; i < kScanWide; ++i) {
        has[i] = m != 0u;
        c[i] = w * 32 + (has[i] ? __ffs(m) - 1 : 0);
        m &= m - 1;
      }
#pragma unroll
      for (int i = 0; i < kScanWide; ++i) ok[i] = woop_pair(buf, kTile, c[i], q, t[i]) && has[i];
#pragma unroll
      for (int i = 0; i < kScanWide; ++i) {
        if (ok[i] && t[i] < best_t && t[i] <= q.t_cap) {
          best_t = t[i];
          best_slot = base + c[i];
        }
      }
    }
  }
  return passed;
}

__global__ void __launch_bounds__(kBlock)
closest_hit_mxu_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                       const float* __restrict__ aabb, const int* __restrict__ order,
                       const __nv_bfloat16* __restrict__ edges, const float* __restrict__ wsum,
                       float* __restrict__ out_t, int* __restrict__ out_slot,
                       int* __restrict__ out_counts, int n_tiles) {
  __shared__ __align__(16) float s_buf[2][kBufFloats];
  __shared__ __align__(16) unsigned short s_rv[kBlock][kK];  // the rays' [d, o x d, 0, 0] in bf16
  __shared__ float s_box[7][kWarps];
  __shared__ float s_best[kWarps];
  __shared__ int s_any[kWarps];
  __shared__ int s_passed[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const long long ray = (long long)blockIdx.x * kBlock + tid;
  const float* r = rays + ray * 8;
  const Ray q = load_ray(r);
  const BlockBox bb = block_box(q, s_box);

  // the ray side of the product, once per block
  unsigned a[2][2];
  float mr[4];
  {
    const float dx = r[3], dy = r[4], dz = r[5];
    const float cx = q.oy * dz - q.oz * dy;
    const float cy = q.oz * dx - q.ox * dz;
    const float cz = q.ox * dy - q.oy * dx;
    const float v[kK] = {dx, dy, dz, cx, cy, cz, 0.0f, 0.0f};
    float rmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      s_rv[tid][k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
      if (k < 6) rmax = fmaxf(rmax, fabsf(v[k]));
    }
    __syncwarp();
    const unsigned* rv = reinterpret_cast<const unsigned*>(&s_rv[warp * 32][0]);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      a[mb][0] = rv[(mb * 16 + g) * (kK / 2) + t4];
      a[mb][1] = rv[(mb * 16 + g + 8) * (kK / 2) + t4];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mr[i] = kMargin * __shfl_sync(kFull, rmax, (i >> 1) * 16 + g + (i & 1) * 8);
  }

  float best_t = fminf(kInf, q.t_cap);
  int best_slot = -1;
  const int* my_order = order + (long long)blockIdx.x * n_tiles;
  int n_steps = 0, n_fetched = 0, n_computed = 0, n_passed = 0;

  // probe tile 0 with the initial best_t
  int ti_cur = my_order[0];
  bool ah;  // a copy of tile j was started (block-uniform)
  {
    const float* b = aabb + (long long)ti_cur * 8;
    float block_best;
    bool any;
    block_max_any(best_t, slab_hit(b, q, best_t), s_best, s_any, block_best, any);
    ah = (tile_lb(b, bb) * kLbSlack < block_best * bb.dmax) && any;
  }
  if (ah) {
    stage_async(s_buf[0], tris, wsum, edges, ti_cur);
    ++n_fetched;
  }
  __pipeline_commit();
  __syncthreads();  // s_best / s_any are rewritten by the loop's first vote

  for (int j = 0; j < n_tiles; ++j) {
    ++n_steps;
    const bool has_next = j + 1 < n_tiles;
    const int ti_next = my_order[has_next ? j + 1 : j];
    const float* b = aabb + (long long)ti_cur * 8;
    const float* bn = aabb + (long long)ti_next * 8;

    // as closest_hit_pipe.cu: one reduction serves both decisions, both on
    // the best_t from before tile j's pairs
    float block_best;
    bool any_next;
    block_max_any(best_t, slab_hit(bn, q, best_t), s_best, s_any, block_best, any_next);
    const float reach = block_best * bb.dmax;
    const bool improve = tile_lb(b, bb) * kLbSlack < reach;
    const bool ah_next =
        has_next && improve && (tile_lb(bn, bb) * kLbSlack < reach) && any_next;

    if (ah_next) {
      stage_async(s_buf[(j + 1) & 1], tris, wsum, edges, ti_next);
      ++n_fetched;
    }
    __pipeline_commit();  // one group per step, empty when nothing was started

    if (ah) {
      __pipeline_wait_prior(1);  // tile j, this thread's chunks
      __syncthreads();           // ... and every other thread's
      if (improve) {
        n_passed += scan_tile_prefiltered(s_buf[j & 1], ti_cur * kTile, q, a, mr, best_t,
                                          best_slot);
        ++n_computed;
      }
    }
    if (!improve) break;
    // buffer (j & 1) is the target of the next step's prefetch, and
    // s_best / s_any are rewritten by its vote
    __syncthreads();
    ah = ah_next;
    ti_cur = ti_next;
  }
  __pipeline_wait_prior(0);  // nothing is in flight here; drain all the same

  out_t[ray] = best_t;
  out_slot[ray] = best_slot;
  if (out_counts != nullptr) {
    if (lane == 0) s_passed[warp] = n_passed;
    __syncthreads();
    if (tid == 0) {
      int passed = 0;
      for (int w = 0; w < kWarps; ++w) passed += s_passed[w];
      int* c = out_counts + (long long)blockIdx.x * 5;
      c[0] = n_steps;
      c[1] = n_fetched;
      c[2] = n_computed;
      c[3] = passed;
      c[4] = n_computed * kBlock * kTile - passed;
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  `out_counts` is null or (n_rays / 128, 5)
// int32: per block the tile steps walked, the tiles fetched, the tiles
// scanned, the (ray, triangle) pairs of the scanned tiles that went through
// the exact test, and those that the prefilter culled.
extern "C" int gpt_closest_hit_mxu(const float* rays, const float* tris, const float* aabb,
                                   const int* order, const void* edges, const float* wsum,
                                   float* out_t, int* out_slot, int* out_counts, int n_rays,
                                   int n_tiles, int tile, void* stream) {
  if (n_rays < 0 || n_rays % kBlock != 0 || n_tiles <= 0 || tile != kTile ||
      reinterpret_cast<size_t>(tris) % 16 != 0 || reinterpret_cast<size_t>(edges) % 16 != 0 ||
      reinterpret_cast<size_t>(wsum) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  closest_hit_mxu_kernel<<<n_rays / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      rays, tris, aabb, order, static_cast<const __nv_bfloat16*>(edges), wsum, out_t, out_slot,
      out_counts, n_tiles);
  return (int)cudaGetLastError();
}
