// The wavefront step's surface shading for Hopper (sm_90a), one thread a ray.
//
// Replaces no TPU kernel: the JAX package computes this step with XLA ops
// (`interpolate_hit` and `sample_bsdf` of gpu_pathtracer_tpu/render/integrator.py
// and gpu_pathtracer_tpu/ops/materials.py), and the port ran it as ~780 torch
// launches a wavefront step.  Its plain version is
// `gpu_pathtracer_tpu_torch.render.integrator.shade_surface_reference`
// (`interpolate_hit`, then `materials.sample_bsdf` without `force_refract`).
// Per ray:
//   1. the hit's packed attr row: the point, the uv and the interpolated
//      vertex normal; where the atlas holds images, the bump map's
//      perturbation in the tangent frame (`onb_from_z_tangent`, or
//      `onb_from_z` where the interpolated tangent is not finite);
//   2. the highest and second-highest prioritised ids on the ray's
//      nested-dielectric stack, and the false-hit test;
//   3. a transparent hit: Schlick, Snell and total internal reflection on
//      the side the ray comes from, the Phong lobe about the bent or
//      reflected direction, its filters and the second interface's factor;
//      an opaque hit: the diffuse / specular pick from the nearest-texel
//      kd and ks, then the cosine or Phong lobe; a false hit passes the ray;
//   4. the pdf and the flags of the `ReflectionRecord`.
// The torch version evaluates every branch and sampler for every ray and
// selects; the kernel computes only the branch a ray takes, with the same
// arithmetic, so it writes the same record.
//
// What bounds it on this card: bytes.  A ray reads 48 B from device memory
// (slot, barycentrics, direction, stack length, four uniforms) and its
// stack's live entries, and gathers a 104 B attr row and a few material rows
// from tables that stay in L2 (972 rows on the main path); it writes 115 B
// (point, uv, shading normal, material id, the record's six vectors, pdf,
// exponent, next material and seven flags).  The arithmetic is a few thousand flops a ray,
// well below the ~0.13 ms byte bound at 2,073,600 rays.  Nothing is kept
// between rays, so the kernel needs no shared memory; each branch's
// temporaries live in registers.
//
// Arithmetic: built with -fmad=false and without fast math, so each
// expression rounds as the separate torch launches of the plain version do
// on the card (see shading_math.cuh).  Further forms of torch's kernels
// followed here: a sum over the triangle's vertices (not the fastest axis) is
// (x0 + x1) + x2, plus +0; v / sqrt(n2) is a true division; x * c for a Python float c
// multiplies by (float)c; torch.square is x * x; sin, cos, pow and sqrt are
// libdevice's sinf, cosf, powf and sqrtf; a float to int cast truncates and a
// NaN texel coordinate reads index 0, as `texture._index` makes torch's do.
//
// Layout (packed by gpu_pathtracer_tpu_torch/ops/materials.py, `surface_tables`):
//   mat_f (M, 16) f32  kd rgb, ks rgb, tf rgb, n_s, n_i, t_r, bm, path_length, 0, 0
//   mat_i (M, 8)  i32  priority, tex_slot (5: diffuse, specular, emission,
//                      n_s, bump), 0, 0
// and the atlas as `texture.Atlas` holds it: rgb (P, 3) f32, offsets,
// heights, widths (K,) i32.

#include <cuda_runtime.h>

#include <climits>
#include <cstring>

#include "shading_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMatCols = 16;
constexpr int kMatIntCols = 8;
constexpr int kVacuumPriority = 9999999;  // constants.VACUUM_PRIORITY
constexpr float kVacuumIor = 1.0f;        // constants.VACUUM_IOR
constexpr float k2Pi = (float)(2.0 * kPi);
constexpr float kPiF = (float)kPi;
constexpr float kInvSqrt3 = 1.0f / (float)1.7320508075688772;  // x / math.sqrt(3.0)
constexpr float kMirrorPdf2 = (float)(1.0 / (2.0 * kPi));

// The argument block: every field 8 bytes, filled by the wrapper as one
// int64 array.  Strides are in elements.
struct Args {
  const int* slot; long long slot_s;
  const float* bary; long long bary_s[2];
  const float* dir; long long dir_s[2];
  const int* stack; long long stack_s[2];
  const int* stack_len; long long stack_len_s;
  const float* u; long long u_s[2];  // (4, R): u_choice, u_pick, u_lobe1, u_lobe2
  const float* attr; long long attr_s[2];  // (T, 26)
  const float* tangent; long long tangent_s[3];  // (T, 3, 3); read where textured
  const float* mat_f;
  const int* mat_i;
  const float* rgb;
  const int* tex_off;
  const int* tex_h;
  const int* tex_w;
  float* out_vec;     // (7, R, 3): point, normal, dir, k, filter, filter_2, perfect_dir
  float* out_uv;      // (R, 2)
  float* out_scalar;  // (2, R): pdf, n
  int* out_int;       // (2, R): mat_id, next_mat
  unsigned char* out_flag;  // (7, R): diffuse, reflected, refracted, false_hit,
                            // entering, bent, sss
  long long n_rays, stack_size, textured;
};
constexpr int kArgSlots = sizeof(Args) / 8;
static_assert(kArgSlots == 37, "integrator._SHADE_ARG_SLOTS");

struct Onb {
  V3 x, y, z;
};

// linalg.normalize without eps
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = sqrtf(sum_last(mul(v, v)));
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// linalg.reflect
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(n, 2.0f * dot(v, n)));
}

// linalg.safe_sqrt
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > kTiny ? sqrtf(clamp_min(x, kTiny)) : 0.0f;
}

// linalg.onb_from_z (branch-free dominant-axis tangent pick)
__device__ __forceinline__ Onb onb_from_z(V3 z) {
  const V3 zu = normalize(z);
  const bool use_x = fabsf(zu.x) > fabsf(zu.y);
  const float inv_a = 1.0f / sqrtf(use_x ? zu.x * zu.x + zu.z * zu.z : zu.y * zu.y + zu.z * zu.z);
  const V3 x = use_x ? V3{zu.z * inv_a, 0.0f * inv_a, -zu.x * inv_a}
                     : V3{0.0f * inv_a, -zu.z * inv_a, zu.y * inv_a};
  return {x, normalize(cross(zu, x)), zu};
}

// linalg.onb_from_z_tangent
__device__ __forceinline__ Onb onb_from_z_tangent(V3 z, V3 x_draft) {
  const V3 zu = normalize(z);
  const V3 xd = normalize(x_draft);
  const V3 y = normalize(cross(zu, xd));
  return {normalize(cross(y, zu)), y, zu};
}

// linalg.to_world
__device__ __forceinline__ V3 to_world(const Onb& b, V3 v) {
  return normalize(add(add(scale(b.x, v.x), scale(b.y, v.y)), scale(b.z, v.z)));
}

// sampling.generate_direction, mode 1: the Phong lobe of exponent n about main_dir
__device__ V3 phong_direction(V3 main_dir, float n, float u1, float u2) {
  const bool mirror = mirror_lobe(n);
  const float n_safe = mirror ? 1.0f : n;
  const float r1 = clamp_min(u1, 1e-12f);
  const float inv = 1.0f / (n_safe + 1.0f);
  const float z = powf(r1, inv);
  const float s = sqrtf(clamp_min(1.0f - powf(r1, inv * 2.0f), 0.0f));
  const float phi = k2Pi * u2;
  const V3 local = mirror ? V3{0.0f, 0.0f, 1.0f}
                          : normalize_eps(V3{s * cosf(phi), s * sinf(phi), z});
  return to_world(onb_from_z(main_dir), local);
}

// sampling.generate_direction, mode 0: the cosine hemisphere about normal
__device__ V3 cosine_direction(V3 normal, float u1, float u2) {
  const float z = sqrtf(clamp_min(1.0f - u2, 0.0f));
  const float phi = k2Pi * u1;
  const float r = sqrtf(clamp_min(u2, 0.0f));
  const V3 local = normalize_eps(V3{cosf(phi) * r, sinf(phi) * r, z});
  return to_world(onb_from_z(normal), local);
}

// sampling.phong_filter's weight (k * w is the filter)
__device__ __forceinline__ float phong_w(float n, V3 ideal, V3 out) {
  const bool mirror = mirror_lobe(n);
  const float n_safe = mirror ? 1.0f : n;
  const float cos_a = clamp_min(dot(ideal, out), 0.0f);
  return mirror ? kMirrorFilter : ((n_safe + 2.0f) * safe_pow(cos_a, n_safe)) * 0.5f;
}

// sampling.phong_filter_2's weight
__device__ __forceinline__ float phong_w2(float n, V3 ideal, V3 out) {
  const bool mirror = mirror_lobe(n);
  const float n_safe = mirror ? 1.0f : n;
  const float cos_a = clamp_min(dot(ideal, out), 0.0f);
  return mirror ? 1.0f : safe_pow(cos_a, n_safe);
}

// sampling.schlick_reflectance
__device__ __forceinline__ float schlick(float cos_theta, float n1, float n2) {
  const float q = (n1 - n2) / (n1 + n2);
  const float r0 = q * q;
  const float m = clamp2(1.0f - cos_theta, 0.0f, 1.0f);
  return r0 + ((((((1.0f - r0) * m) * m) * m) * m) * m);
}

// materials._snell_out_dir
__device__ V3 snell_out_dir(V3 v_in, V3 normal, float cos1, float sin_ratio, float sign) {
  const float sin1 = safe_sqrt(1.0f - cos1 * cos1);
  const V3 v_par = sub(v_in, scale(normal, sign * cos1));
  const float sin2 = sin_ratio * sin1;
  const float cos2 = safe_sqrt(1.0f - sin2 * sin2);
  const float tan2 = sin2 / clamp_min(cos2, 1e-20f);
  const bool straight = fabsf(tan2) <= kSmallEps;
  if (straight) return scale(normal, sign);
  const float inv_tan = 1.0f / clamp_min(tan2, kSmallEps);
  const float par_len = sqrtf(sum_last(mul(v_par, v_par)));
  return normalize_eps(add(v_par, scale(normal, (sign * inv_tan) * par_len)));
}

// texture._index: floor(x) as an index, NaN to 0
__device__ __forceinline__ long long texel_axis(float x) {
  const float f = floorf(x);
  return isnan(f) ? 0 : (long long)f;
}

struct Shader {
  const Args& a;

  __device__ const float* mf(int id) const { return a.mat_f + (long long)max(id, 0) * kMatCols; }
  __device__ const int* mi(int id) const { return a.mat_i + (long long)max(id, 0) * kMatIntCols; }
  __device__ int priority(int id) const { return id < 0 ? kVacuumPriority : mi(id)[0]; }
  __device__ float ior(int id) const { return id < 0 ? kVacuumIor : mf(id)[10]; }

  // texture.lookup: the nearest texel of atlas image `slot` (white without images)
  __device__ V3 lookup(int slot, float u, float v) const {
    if (!a.textured) return {1.0f, 1.0f, 1.0f};
    const int w = a.tex_w[slot], h = a.tex_h[slot];
    const long long iu = texel_axis((u - floorf(u)) * (float)(w - 1));
    const long long iv = texel_axis((v - floorf(v)) * (float)(h - 1));
    const float* p = a.rgb + 3 * ((long long)a.tex_off[slot] + (long long)w * iv + iu);
    return {p[0], p[1], p[2]};
  }

  // MaterialTable._tex: channel 0 diffuse, 1 specular (times kd / ks)
  __device__ V3 color(int id, int channel, float u, float v) const {
    return mul(lookup(mi(id)[1 + channel], u, v), load_v3(mf(id) + 3 * channel));
  }

  static __device__ V3 load_v3(const float* p) { return {p[0], p[1], p[2]}; }

  // MaterialTable.phong_exponent
  __device__ float phong_exponent(int id, float u, float v) const {
    const float n_s = mf(id)[9];
    const bool inf = isinf(n_s);
    const float filt = (inf ? 0.0f : n_s) * kInvSqrt3;
    const V3 t = scale(lookup(mi(id)[4], u, v), filt);
    const float len = sqrtf(clamp_min(sum_last(mul(t, t)), 1e-30f));
    return inf ? INFINITY : len;
  }

  // MaterialTable.bump_vector (called only where the atlas holds images)
  __device__ V3 bump_vector(int id, float u, float v) const {
    const int slot = mi(id)[5];
    const bool has = a.tex_h[slot] >= 2 && a.tex_w[slot] >= 2;
    const V3 tex = lookup(slot, u, v);
    const float bm2 = 2.0f * mf(id)[12];
    return has ? V3{bm2 * (tex.x - 0.5f), bm2 * (tex.y - 0.5f), bm2 * (tex.z - 0.5f)}
               : V3{0.0f, 0.0f, 0.0f};
  }
};

__global__ void __launch_bounds__(kThreads) shade_surface_kernel(Args a) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n_rays) return;
  const Shader sh{a};
  const long long R = a.n_rays;

  // 1. interpolate_hit
  const long long s = max(a.slot[r * a.slot_s], 0);
  const V3 b = load3(a.bary, a.bary_s, r);
  const float* row = a.attr + s * a.attr_s[0];
  const long long ac = a.attr_s[1];
  // the sum over the vertices of b_v * row[first + stride * v + c]
  auto interp = [&](int first, int stride, int c) {
    return ((b.x * row[(first + c) * ac] + b.y * row[(first + stride + c) * ac]) +
            b.z * row[(first + 2 * stride + c) * ac]) + 0.0f;
  };
  const V3 point{interp(0, 3, 0), interp(0, 3, 1), interp(0, 3, 2)};
  const V3 n = normalize_eps(V3{interp(9, 3, 0), interp(9, 3, 1), interp(9, 3, 2)});
  const float uv0 = interp(18, 2, 0), uv1 = interp(18, 2, 1);
  const int mat = (int)row[25 * ac];
  V3 normal = n;
  if (a.textured) {
    const V3 bump = sh.bump_vector(mat, uv0, uv1);
    const float* tp = a.tangent + s * a.tangent_s[0];
    const long long t1 = a.tangent_s[1], t2 = a.tangent_s[2];
    auto tan_c = [&](int c) {
      return ((b.x * tp[c * t2] + b.y * tp[t1 + c * t2]) + b.z * tp[2 * t1 + c * t2]) + 0.0f;
    };
    const V3 tangent{tan_c(0), tan_c(1), tan_c(2)};
    const bool tan_ok = isfinite(tangent.x) && isfinite(tangent.y) && isfinite(tangent.z);
    const Onb f = tan_ok ? onb_from_z_tangent(n, normalize_eps(tangent)) : onb_from_z(n);
    if (sqrtf(sum_last(mul(bump, bump))) > 0.0f)
      normal = normalize_eps(add(add(n, scale(f.x, bump.x)), scale(f.y, bump.y)));
  }

  // 2. the stack's highest and second-highest prioritised ids
  //    (materials.find_highest_prioritised, int32 keys as torch computes them)
  const int* st = a.stack + r * a.stack_s[0];
  const long long ss = a.stack_s[1];
  const int len = a.stack_len[r * a.stack_len_s];
  const int size = (int)a.stack_size;
  auto key_of = [&](int j, int& pri) {
    pri = j < len ? sh.priority(st[j * ss]) : kVacuumPriority + 1;
    return (int)((unsigned)pri * (unsigned)(size + 1) + (unsigned)(size - 1 - j));
  };
  int min_key = INT_MAX;
  for (int j = 0; j < size; ++j) {
    int pri;
    min_key = min(min_key, key_of(j, pri));
  }
  const int q = min_key / (size + 1);
  const int hp_pri = (min_key % (size + 1) != 0 && min_key < 0) ? q - 1 : q;  // floor division
  long long hp_sum = 0;
  int min_key2 = INT_MAX;
  bool any2 = false;
  for (int j = 0; j < size; ++j) {
    int pri;
    const int key = key_of(j, pri);
    if (key == min_key) hp_sum += st[j * ss];
    if (j < len && pri > hp_pri && pri < kVacuumPriority) {
      any2 = true;
      min_key2 = min(min_key2, key);
    }
  }
  long long shp_sum = 0;
  for (int j = 0; any2 && j < size; ++j) {
    int pri;
    const int key = key_of(j, pri);
    if (key == min_key2 && j < len && pri > hp_pri && pri < kVacuumPriority) shp_sum += st[j * ss];
  }
  const int hp = hp_pri >= kVacuumPriority ? -1 : (int)hp_sum;
  const int shp = any2 ? (int)shp_sum : -1;
  const bool false_hit = sh.priority(mat) > sh.priority(hp);

  // 3. sample_bsdf
  const V3 v_in = load3(a.dir, a.dir_s, r);
  const float* u = a.u + r * a.u_s[1];
  const float u_choice = u[0], u_pick = u[a.u_s[0]];
  const float u_lobe1 = u[2 * a.u_s[0]], u_lobe2 = u[3 * a.u_s[0]];
  const float* m = sh.mf(mat);
  const float n_i = m[10], t_r = m[11];
  const float d_in_n = dot(v_in, normal);
  const bool entering_geom = d_in_n <= 0.0f;
  const V3 refl_dir = normalize_eps(reflect(v_in, normal));
  const V3 kd_tex = sh.color(mat, 0, uv0, uv1);
  const V3 ks_tex = sh.color(mat, 1, uv0, uv1);
  const float kd_len = sqrtf(sum_last(mul(kd_tex, kd_tex)));
  const float ks_len = sqrtf(sum_last(mul(ks_tex, ks_tex)));
  const float denom = kd_len + ks_len;
  // kd = ks = 0 (pure emitters): the reference's 0/0 lands in the specular branch
  const float spec_prob = denom > 0.0f ? ks_len / clamp_min(denom, 1e-20f) : 1.0f;
  const bool choose_spec = u_pick <= spec_prob;

  const V3 one{1.0f, 1.0f, 1.0f};
  V3 direction = v_in, perfect = choose_spec ? refl_dir : normal, k = one, filt = one, filt2 = one;
  float n_eff = 1.0f, pdf = 1.0f;
  bool diffuse = false, reflected = false, refracted = true, entering = entering_geom;
  bool bent = false, sss = false;
  int next_mat = hp;
  if (!false_hit) {
    if (t_r > 0.0f) {  // the refraction branch
      const float n_s = sh.phong_exponent(mat, uv0, uv1);
      const float hp_ior = sh.ior(hp), shp_ior = sh.ior(shp);
      V3 v_out;
      bool refracted_t;
      int next_t;
      float ior_other;
      if (entering_geom) {
        const float cos1_in = -d_in_n;
        const bool refract_in = u_choice >= schlick(cos1_in, hp_ior, n_i);
        v_out = refract_in ? snell_out_dir(v_in, normal, cos1_in, hp_ior / n_i, -1.0f) : refl_dir;
        refracted_t = refract_in;
        entering = refract_in;
        next_t = refract_in ? mat : hp;
        ior_other = hp_ior;
      } else {
        const float cos1_out = d_in_n;
        const float sin1_out = safe_sqrt(1.0f - cos1_out * cos1_out);
        const bool reflect_out =
            sin1_out >= shp_ior / n_i || u_choice <= schlick(cos1_out, n_i, shp_ior);
        v_out = reflect_out ? normalize_eps(reflect(v_in, neg(normal)))
                            : snell_out_dir(v_in, normal, cos1_out, n_i / shp_ior, 1.0f);
        refracted_t = !reflect_out;
        entering = false;
        next_t = reflect_out ? mat : shp;
        ior_other = shp_ior;
      }
      direction = phong_direction(v_out, n_s, u_lobe1, u_lobe2);
      k = scale(Shader::load_v3(m + 6), t_r);
      filt = scale(k, phong_w(n_s, v_out, direction));
      filt2 = scale(k, phong_w2(n_s, v_out, direction));
      if (next_t >= 0 && next_t != mat) {  // the second interface's factor
        const float* m2 = sh.mf(next_t);
        const V3 k2 = scale(Shader::load_v3(m2 + 6), m2[11]);
        const float n_s2 = sh.phong_exponent(next_t, uv0, uv1);
        k = mul(k, k2);
        filt = mul(filt, scale(k2, phong_w(n_s2, v_out, direction)));
        filt2 = mul(filt2, scale(k2, phong_w2(n_s2, v_out, direction)));
      }
      perfect = v_out;
      n_eff = n_s;
      reflected = !refracted_t;
      refracted = refracted_t;
      bent = refracted_t && fabsf(ior_other - n_i) > kSmallEps;
      next_mat = next_t;
    } else {  // the opaque branch
      entering = false;
      refracted = false;
      if (choose_spec) {
        const float n_s = sh.phong_exponent(mat, uv0, uv1);
        direction = phong_direction(refl_dir, n_s, u_lobe1, u_lobe2);
        filt = scale(ks_tex, phong_w(n_s, refl_dir, direction));
        filt2 = scale(ks_tex, phong_w2(n_s, refl_dir, direction));
        k = ks_tex;
        n_eff = n_s;
        reflected = true;
      } else {
        direction = cosine_direction(normal, u_lobe1, u_lobe2);
        filt = filt2 = k = kd_tex;
        diffuse = true;
        sss = m[13] > 0.0f;
      }
    }
    // pdf = sampling_pdf_2 * pi / scattering_pdf
    const float d1 = dot(v_in, normal);
    const float d2 = dot(normal, direction);
    const bool side_ok = refracted ? same_side(d1, d2) : opposite_side(d1, d2);
    float samp, scat;
    if (diffuse) {
      samp = clamp_min(d2 * kInvPi, 0.0f);
      scat = clamp_min(d2, 0.0f);
    } else {
      const bool mirror = mirror_lobe(n_eff);
      const float n_safe = mirror ? 1.0f : n_eff;
      const float cos_a = clamp_min(dot(perfect, direction), 0.0f);
      const float lobe = safe_pow(cos_a, n_safe) * kInv2Pi;
      samp = side_ok ? (mirror ? kMirrorPdf2 : lobe) : 0.0f;
      scat = side_ok ? 1.0f : 0.0f;
    }
    pdf = (samp * kPiF) / (scat != 0.0f ? scat : 1.0f);
  }

  // 4. the record
  float* ov = a.out_vec;
  store3(ov, r, point);
  store3(ov + 3 * R, r, normal);
  store3(ov + 6 * R, r, direction);
  store3(ov + 9 * R, r, k);
  store3(ov + 12 * R, r, filt);
  store3(ov + 15 * R, r, filt2);
  store3(ov + 18 * R, r, perfect);
  a.out_uv[2 * r] = uv0;
  a.out_uv[2 * r + 1] = uv1;
  a.out_scalar[r] = pdf;
  a.out_scalar[R + r] = n_eff;
  a.out_int[r] = mat;
  a.out_int[R + r] = next_mat;
  unsigned char* of = a.out_flag;
  of[r] = diffuse;
  of[R + r] = reflected;
  of[2 * R + r] = refracted;
  of[3 * R + r] = false_hit;
  of[4 * R + r] = entering;
  of[5 * R + r] = bent;
  of[6 * R + r] = sss;
}

}  // namespace

// C entry point, loaded with ctypes.  `args` is the host copy of the kernel's
// argument block (`Args`, kArgSlots 8-byte fields).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched); refuses a stack size below 1.
extern "C" int gpt_shade_surface(const long long* args, void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.n_rays < 0 || a.stack_size < 1 || a.stack_size > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  if (a.n_rays == 0) return 0;
  const long long blocks = (a.n_rays + kThreads - 1) / kThreads;
  shade_surface_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
