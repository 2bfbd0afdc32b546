// The dense light tree's NEE/MIS step for Hopper (sm_90a), one thread a ray.
//
// Replaces no TPU kernel: the JAX package computes this step with XLA ops
// (`_nee_mis` of gpu_pathtracer_tpu/render/integrator.py, the dense branch
// of gpu_pathtracer_tpu/ops/lights.py), and the port ran it as ~460 torch
// launches a wavefront step, among them an aten cumsum over a (R, E) table.
// Its plain version is `gpu_pathtracer_tpu_torch.ops.lights.nee_dense_reference`
// (`nee_mis` and the integrator's `do_nee` selects).  Per ray:
//   1. the pivot (normal for diffuse lobes, else the perfect direction) and
//      the light weight w (0 where the Phong exponent is inf);
//   2. the importance of each of the 2E-1 light-tree nodes, the branch ratios
//      imp / (imp + imp_sibling) (non-finite -> 0.5, root -> 1), and each
//      leaf's selection pdf exp(sum of log(clamp(ratio, 1e-35, 1))) over its
//      root-to-leaf path, nodes in ascending id (the order of the (R, 2E-1) x
//      (2E-1, E) product over the ancestor matrix);
//   3. the inverse-CDF pick: leaf = number of prefix sums < u * total,
//      clamped to [0, E-1];
//   4. the point on the chosen emitter, the light direction, the next
//      direction and the Phong filter where a reflected or refracted lobe
//      takes the light;
//   5. the mixture pdf: a watertight hit against every emitter, t^2 / (|cos|
//      area) weighted by the leaf pdfs, then the lobe's sampling pdf, the
//      scattering pdf and the factor;
//   6. the integrator's do_nee selects (elsewhere: the lobe's direction and
//      filter, factor 1), written straight to the outputs.
//
// What bounds it on this card: bytes.  A ray reads ~110 B (seven 3-vectors,
// the exponent, four uniforms, four flags) and writes 28 B; the light
// tree's tables are a few hundred bytes at the main path's 2 emitters, so
// the (R, 2E-1) and (R, E) tables of the torch version never reach device
// memory: each thread keeps its node ratios, leaf pdfs and prefix sums in
// shared memory (its own column of a (3E-1, threads) scratch), and the
// tables are loaded into shared memory once a block.  The arithmetic is ~1k
// flops a ray at E = 2, below the byte bound's ~0.1 ms at 2,073,600 rays.
//
// Arithmetic: built with -fmad=false and without fast math, so each
// expression rounds as the separate torch launches of the plain version do
// on the card.  Where torch's CUDA kernels fix an order or a form, the
// kernel follows it: a sum over a contiguous last axis of 3 is (x0 + x2) +
// x1 and one of E terms the warp-shuffle tree of aten's block-x reduction
// (aten/native/cuda/Reduce.cuh); a sum over the triangle's vertices (not the
// fastest axis) is (x0 + x1) + x2; the prefix sums are aten's Sklansky scan
// (ScanUtils.cuh); x / c for a Python float c is x * (1 / (float)c); clamp
// and max propagate NaN; the argmax picks the first maximum, NaN first.
//
// Layout (packed by gpu_pathtracer_tpu_torch/ops/lights.py, `nee_tables`):
//   node  (2E-1, 12) f32  box centre xyz, energy rgb, leaf centroid xyz,
//                         leaf average normal xyz (0 for internal nodes)
//   leaf  (E, 20)    f32  triangle vertices (9), vertex normals (9), area, tol
//   ints  (2E-1 + E * D) i32  sibling of each node (root -> itself), then
//                         each leaf's path, D node ids ascending, padded
//                         with 2E-1 (D = the tree's depth)

#include <cuda_runtime.h>

#include <cstring>

#include "shading_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLights = 32;  // lights.NEE_DENSE_MAX_LIGHTS
constexpr int kNodeCols = 12;
constexpr int kLeafCols = 20;
constexpr float kSplit = 4097.0f;  // intersect._SPLIT
constexpr float kMirrorPdf = (float)(kMaxPhongNs / (2.0 * kPi));

// The argument block: every field 8 bytes, filled by the wrapper as one
// int64 array.  Strides are in elements.
struct Args {
  const float* origin; long long origin_s[2];
  const float* dir; long long dir_s[2];
  const float* k; long long k_s[2];
  const float* filter; long long filter_s[2];
  const float* perfect; long long perfect_s[2];
  const float* normal; long long normal_s[2];
  const float* coming; long long coming_s[2];
  const float* u; long long u_s[2];  // (4, R): accept, pick, u1, u2
  const float* n; long long n_s;
  const unsigned char* diffuse; long long diffuse_s;
  const unsigned char* reflected; long long reflected_s;
  const unsigned char* refracted; long long refracted_s;
  const unsigned char* do_nee; long long do_nee_s;
  const float* node;
  const float* leaf;
  const int* ints;
  float* out_dir;
  float* out_filter;
  float* out_factor;
  long long n_rays, n_lights, depth;
};
constexpr int kArgSlots = sizeof(Args) / 8;
static_assert(kArgSlots == 43, "lights._NEE_ARG_SLOTS");

// lights._dense_importance of one node
__device__ __forceinline__ float importance(const float* nd, bool is_leaf, V3 p, V3 pivot) {
  const V3 d = sub(p, V3{nd[0], nd[1], nd[2]});
  const float dist2 = clamp_min(sum_last(mul(d, d)), 1e-30f);
  V3 eff{nd[3], nd[4], nd[5]};
  if (is_leaf) {
    const V3 dtp = normalize_eps(sub(p, V3{nd[6], nd[7], nd[8]}));
    const float fac = clamp_min(dot(V3{nd[9], nd[10], nd[11]}, dtp) * dot(neg(dtp), pivot), 0.0f);
    eff = scale(eff, fac);
  }
  return sqrtf(sum_last(mul(eff, eff))) / dist2;
}

// intersect._two_product / _diff_of_products_exact
__device__ __forceinline__ void two_product(float a, float b, float& p, float& err) {
  p = a * b;
  const float a1 = a * kSplit;
  const float a_hi = a1 - (a1 - a);
  const float a_lo = a - a_hi;
  const float b1 = b * kSplit;
  const float b_hi = b1 - (b1 - b);
  const float b_lo = b - b_hi;
  err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}
__device__ __forceinline__ float diff_products_exact(float a, float b, float c, float d) {
  float p1, e1, p2, e2;
  two_product(a, b, p1, e1);
  two_product(c, d, p2, e2);
  return (p1 - p2) + (e1 - e2);
}

// intersect._permute3 with kx = (kz + 1) % 3, ky = (kz + 2) % 3
__device__ __forceinline__ V3 permute3(int kz, V3 v) {
  return {kz == 0 ? v.y : (kz == 1 ? v.z : v.x),
          kz == 0 ? v.z : (kz == 1 ? v.x : v.y),
          kz == 0 ? v.x : (kz == 1 ? v.y : v.z)};
}

// torch.argmax over 3 values: the largest, NaN above all, the first on ties
__device__ __forceinline__ bool greater_or_nan(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

// lights.hittable_pdf_sum's term of one emitter before its leaf pdf: t^2 /
// (|cos| area) at the watertight hit of the ray (o, d) with the emitter's
// triangle (intersect.intersect_tris with t_max = inf), 0 on a miss; kz is
// argmax |d|
__device__ float geom_pdf(const float* lf, V3 o, V3 d, int kz) {
  const V3 dp = permute3(kz, d);
  const float sx = -dp.x / dp.z;
  const float sy = -dp.y / dp.z;
  const float sz = 1.0f / dp.z;
  float x[3], y[3], zs[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const V3 p = permute3(kz, sub(V3{lf[3 * v], lf[3 * v + 1], lf[3 * v + 2]}, o));
    x[v] = p.x + sx * p.z;
    y[v] = p.y + sy * p.z;
    zs[v] = p.z * sz;
  }
  float e1 = x[1] * y[2] - y[1] * x[2];
  float e2 = x[2] * y[0] - y[2] * x[0];
  float e3 = x[0] * y[1] - y[0] * x[1];
  if (e1 == 0.0f || e2 == 0.0f || e3 == 0.0f) {
    e1 = diff_products_exact(x[1], y[2], y[1], x[2]);
    e2 = diff_products_exact(x[2], y[0], y[2], x[0]);
    e3 = diff_products_exact(x[0], y[1], y[0], x[1]);
  }
  const bool mixed = (e1 < 0.0f || e2 < 0.0f || e3 < 0.0f) && (e1 > 0.0f || e2 > 0.0f || e3 > 0.0f);
  const float det = (e1 + e2) + e3;
  const float t_scaled = (e1 * zs[0] + e2 * zs[1]) + e3 * zs[2];
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float t = t_scaled * inv_det;
  const float tol = lf[19];
  if (mixed || det == 0.0f || !(t <= INFINITY) || !(t >= tol)) return 0.0f;
  const float b0 = e1 * inv_det, b1 = e2 * inv_det, b2 = e3 * inv_det;
  const float* nv = lf + 9;
  // the sum over the three vertices (not the fastest axis): (x0 + x1) + x2
  const V3 nh = normalize_eps(V3{(b0 * nv[0] + b1 * nv[3]) + b2 * nv[6],
                                 (b0 * nv[1] + b1 * nv[4]) + b2 * nv[7],
                                 (b0 * nv[2] + b1 * nv[5]) + b2 * nv[8]});
  const float cos = fabsf(dot(d, nh));
  return (t * t) / clamp_min(cos * lf[18], 1e-20f);
}

// aten's block-x sum of the n <= 32 values v[0], v[kThreads], ... in place
// (one lane a value, a lane holding x_t + x_{t+w} past the warp width w =
// last power of 2 <= n, then the intra-warp shuffle with falling offsets);
// returns the sum
__device__ __forceinline__ float block_x_sum(float* v, int n) {
  int w = 1;
  while (2 * w <= n) w *= 2;
  for (int t = 0; t + w < n; ++t) v[t * kThreads] = v[t * kThreads] + v[(t + w) * kThreads];
  for (int o = w / 2; o > 0; o /= 2)
    for (int t = 0; t < o; ++t) v[t * kThreads] = v[t * kThreads] + v[(t + o) * kThreads];
  return v[0];
}

// aten's inclusive Sklansky scan of v[0 .. n) in place (torch.cumsum over a
// last axis of n <= 32: one block of the scan, n fits in its 2 * 16 lanes)
__device__ __forceinline__ void sklansky_scan(float* v, int n) {
  for (int s = 1; s < n; s *= 2)
    for (int i = 0; i < n; ++i)
      if (i & s) v[i * kThreads] = v[i * kThreads] + v[((i & ~(2 * s - 1)) + s - 1) * kThreads];
}

__global__ void __launch_bounds__(kThreads) nee_dense_kernel(Args a, float weight) {
  extern __shared__ float smem[];
  const int e = (int)a.n_lights;
  const int n_nodes = 2 * e - 1;
  const int depth = (int)a.depth;
  float* s_node = smem;
  float* s_leaf = s_node + n_nodes * kNodeCols;
  int* s_int = reinterpret_cast<int*>(s_leaf + e * kLeafCols);
  float* s_scratch = reinterpret_cast<float*>(s_int + n_nodes + e * depth);
  for (int i = threadIdx.x; i < n_nodes * kNodeCols; i += kThreads) s_node[i] = a.node[i];
  for (int i = threadIdx.x; i < e * kLeafCols; i += kThreads) s_leaf[i] = a.leaf[i];
  for (int i = threadIdx.x; i < n_nodes + e * depth; i += kThreads) s_int[i] = a.ints[i];
  __syncthreads();

  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n_rays) return;
  const V3 lobe_dir = load3(a.dir, a.dir_s, r);
  const V3 lobe_filter = load3(a.filter, a.filter_s, r);
  if (!a.do_nee[r * a.do_nee_s]) {
    store3(a.out_dir, r, lobe_dir);
    store3(a.out_filter, r, lobe_filter);
    a.out_factor[r] = 1.0f;
    return;
  }
  // this thread's columns of the scratch: A (2E-1 values), B (E values)
  float* A = s_scratch + threadIdx.x;
  float* B = A + n_nodes * kThreads;

  const V3 origin = load3(a.origin, a.origin_s, r);
  const V3 normal = load3(a.normal, a.normal_s, r);
  const V3 perfect = load3(a.perfect, a.perfect_s, r);
  const V3 coming = load3(a.coming, a.coming_s, r);
  const float n = a.n[r * a.n_s];
  const bool diffuse = a.diffuse[r * a.diffuse_s] != 0;
  const bool reflected = a.reflected[r * a.reflected_s] != 0;
  const bool refracted = a.refracted[r * a.refracted_s] != 0;
  const float* u = a.u + r * a.u_s[1];
  const float u_accept = u[0], u_pick = u[a.u_s[0]], u1 = u[2 * a.u_s[0]], u2 = u[3 * a.u_s[0]];

  // 1. pivot and light weight
  const V3 pivot = pick3(diffuse, normal, perfect);
  const float w = isinf(n) ? 0.0f : weight;
  const bool take_light = u_accept < w;

  // 2. the leaves' selection pdfs, into B
  if (e == 1) {
    B[0] = 1.0f;
  } else {
    for (int j = 0; j < n_nodes; ++j)
      A[j * kThreads] = importance(s_node + j * kNodeCols, j >= e - 1, origin, pivot);
    for (int j = 1; j < n_nodes; ++j) {
      const int s = s_int[j];
      if (s < j) continue;  // the pair was done at s
      const float ia = A[j * kThreads], ib = A[s * kThreads];
      float ra = ia / (ia + ib), rb = ib / (ib + ia);
      ra = isfinite(ra) ? ra : 0.5f;
      rb = isfinite(rb) ? rb : 0.5f;
      A[j * kThreads] = logf(clamp2(ra, 1e-35f, 1.0f));
      A[s * kThreads] = logf(clamp2(rb, 1e-35f, 1.0f));
    }
    A[0] = 0.0f;  // the root's ratio is 1
    const int* paths = s_int + n_nodes;
    for (int l = 0; l < e; ++l) {
      float acc = 0.0f;
      for (int k = 0; k < depth; ++k) {
        const int node = paths[l * depth + k];
        if (node >= n_nodes) break;
        acc = acc + A[node * kThreads];
      }
      B[l * kThreads] = expf(acc);
    }
  }

  // 3. the inverse-CDF pick over the prefix sums (into A)
  for (int l = 0; l < e; ++l) A[l * kThreads] = B[l * kThreads];
  sklansky_scan(A, e);
  const float threshold = u_pick * A[(e - 1) * kThreads];
  int leaf = 0;
  for (int l = 0; l < e; ++l) leaf += A[l * kThreads] < threshold ? 1 : 0;
  leaf = min(max(leaf, 0), e - 1);

  // 4. the point on the emitter, the next direction and its filter
  const float* lf = s_leaf + leaf * kLeafCols;
  const float sq = sqrtf(clamp_min(u1, 0.0f));
  const float bu = 1.0f - sq;
  const float bv = u2 * sq;
  const float bw = (1.0f - bu) - bv;
  const V3 target{(bu * lf[0] + bv * lf[3]) + bw * lf[6], (bu * lf[1] + bv * lf[4]) + bw * lf[7],
                  (bu * lf[2] + bv * lf[5]) + bw * lf[8]};
  const V3 new_dir = take_light ? normalize_eps(sub(target, origin)) : lobe_dir;
  const bool mirror = mirror_lobe(n);
  const float n_safe = mirror ? 1.0f : n;
  V3 new_filter = lobe_filter;
  if (take_light && (reflected || refracted)) {
    const float cos_a = clamp_min(dot(pivot, new_dir), 0.0f);
    const float wf = mirror ? kMirrorFilter : ((n_safe + 2.0f) * safe_pow(cos_a, n_safe)) * 0.5f;
    new_filter = scale(load3(a.k, a.k_s, r), wf);
  }

  // 5. the mixture pdf and the factor
  const V3 ad{fabsf(new_dir.x), fabsf(new_dir.y), fabsf(new_dir.z)};
  int kz = 0;
  float best = ad.x;
  if (greater_or_nan(ad.y, 1, best, kz)) { best = ad.y; kz = 1; }
  if (greater_or_nan(ad.z, 2, best, kz)) { best = ad.z; kz = 2; }
  for (int l = 0; l < e; ++l)
    A[l * kThreads] = B[l * kThreads] * geom_pdf(s_leaf + l * kLeafCols, origin, new_dir, kz);
  const float hittable = block_x_sum(A, e);
  const float nd = dot(normal, new_dir);
  const float d1 = dot(coming, normal);
  const bool side_ok = refracted ? same_side(d1, nd) : opposite_side(d1, nd);
  float samp;
  if (diffuse) {
    samp = clamp_min(nd * kInvPi, 0.0f);
  } else {
    const float cos_a = clamp_min(dot(perfect, new_dir), 0.0f);
    const float lobe = ((n_safe + 1.0f) * safe_pow(cos_a, n_safe)) * kInv2Pi;
    samp = side_ok ? (mirror ? kMirrorPdf : lobe) : 0.0f;
  }
  const float pdf = w * hittable + (1.0f - w) * samp;
  const float scat = diffuse ? clamp_min(nd, 0.0f) : (side_ok ? 1.0f : 0.0f);
  const float factor = pdf != 0.0f ? (scat * kInvPi) / pdf : 0.0f;

  // 6. written straight to the outputs (do_nee holds here)
  store3(a.out_dir, r, new_dir);
  store3(a.out_filter, r, new_filter);
  a.out_factor[r] = factor;
}

}  // namespace

// C entry point, loaded with ctypes.  `args` is the host copy of the kernel's
// argument block (`Args`, kArgSlots 8-byte fields); `weight` the integrator's
// hittable_pdf_weight.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched); refuses a light count outside [1, kMaxLights].
extern "C" int gpt_nee_dense(const long long* args, float weight, void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  const long long e = a.n_lights;
  if (a.n_rays < 0 || e < 1 || e > kMaxLights || a.depth < 1 || a.depth > 2 * e - 1)
    return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const long long n_nodes = 2 * e - 1;
  const size_t smem = sizeof(float) * (n_nodes * kNodeCols + e * kLeafCols) +
                      sizeof(int) * (n_nodes + e * a.depth) +
                      sizeof(float) * (n_nodes + e) * kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nee_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (a.n_rays + kThreads - 1) / kThreads;
  nee_dense_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, weight);
  return (int)cudaGetLastError();
}
