// Device code shared by the VRL sum (vrl_sum.cu), its VJP
// (vrl_sum_bwd.cu), the clustered sum (vrl_sum_clustered.cu), its VJP
// (vrl_sum_clustered_bwd.cu), the transfer matrix (vrl_r.cu) and the
// BVH-occlusion sum (vrl_sum_bvh.cu): the pack layouts, the Philox
// stream, the phase functions, the shadow test (the Wald test of one
// triangle, and the flat sweep as one occlusion policy), the
// clustered tables' staging (stage_table_piece), the two samplers of the
// estimator, the two media (homogeneous, Medium; grid, GridMedium), the
// estimator itself (pair_terms, templated on the medium and, for the
// material instantiations of kernels 1-7, on MAT: the eye hit's smooth
// BSDF, eval_smooth over the material table), its cotangents
// (vol_vol_cot / vol_surf_cot, one overload per medium, with the
// material, extended-pack and trilinear forms of kernels 8-11) and the
// backwards' fixed-order reductions. The backward replays the forward's
// samples, so all kernels take them from the same loop here
// (pair_samples), in the same draw order.
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// vrl_sum.cu: the plane pack (PlaneTris) of T >= 1 triangles into `out`
// (T, 4 PLANE_F4) floats on `stream`; returns a cudaError_t. The kernels
// that sweep a plane pack make it through here in front of their launch.
extern "C" int alvrl_plane_pack(const float* tris, int T, float* out, void* stream);

// vrl_sum_tex.cu, vrl_sum_clustered_tex.cu, vrl_r_tex.cu: the textured
// forms of kernels 1, 2 and 5 (vrl_tex.cuh), which
// alvrl_vrl_sum, alvrl_vrl_sum_clustered and alvrl_vrl_r launch when their
// `tex` is set, with their other arguments.
extern "C" int alvrl_vrl_sum_tex(const float* rays, int B, const float* vrls, int N,
                                 const float* tris, int T, const float* med,
                                 const float* mat_table, int M, const float* rt,
                                 const float* uniforms, unsigned int seed, int svv, int svs,
                                 int short_vrls, int phase_kind, float* planes, int mode,
                                 unsigned long long* counts, float* partial, int n_chunks,
                                 float* out, void* stream);
extern "C" int alvrl_vrl_sum_clustered_tex(const float* rays, int B, const float* vrls, int N,
                                           const float* tris, int T, const float* med,
                                           const float* mat_table, int M, const float* rt,
                                           const int* tile_rays, const int* tile_row,
                                           int n_tiles, const int* table_ids,
                                           const float* table_w, int C, const float* uniforms,
                                           unsigned int seed, int svv, int svs, int short_vrls,
                                           int phase_kind, float* planes, int mode,
                                           unsigned long long* counts, float* out,
                                           void* stream);
extern "C" int alvrl_vrl_r_tex(const float* rays, int B, const float* vrls, int N,
                               const float* tris, int T, const float* med,
                               const float* mat_table, int M, const float* rt,
                               const float* uniforms, unsigned int seed, int svv, int svs,
                               int short_vrls, int phase_kind, float* planes, int mode,
                               unsigned long long* counts, float* out, void* stream);

// vrl_sum_grid_tex.cu, vrl_sum_clustered_grid_tex.cu, vrl_r_grid_tex.cu,
// vrl_sum_bvh_tex.cu: the textured forms of kernels 3, 4, 6 and 7 (the
// material forms' bodies with TEX set; vrl_tex.cuh), which
// alvrl_vrl_sum_hetero, alvrl_vrl_sum_hetero_clustered, alvrl_vrl_r_hetero
// and alvrl_vrl_sum_bvh launch when their `tex` is set, with their other
// arguments.
extern "C" int alvrl_vrl_sum_hetero_tex(const float* rays, int B, const float* vrls, int N,
                                        const float* tris, int T, const float* med,
                                        const float* mat_table, int M, const float* rt,
                                        const float* density, int nz, int ny, int nx,
                                        int uv_steps, int trilinear, const float* uniforms,
                                        unsigned int seed, int svv, int svs, int short_vrls,
                                        int phase_kind, float* partial, int n_chunks, float* out,
                                        void* stream);
extern "C" int alvrl_vrl_sum_hetero_clustered_tex(
    const float* rays, int B, const float* vrls, int N, const float* tris, int T, const float* med,
    const float* mat_table, int M, const float* rt, const float* density, int nz, int ny, int nx,
    int uv_steps, int trilinear, const int* tile_rays, const int* tile_row, int n_tiles,
    const int* table_ids, const float* table_w, int C, const float* uniforms, unsigned int seed,
    int svv, int svs, int short_vrls, int phase_kind, float* planes, int mode,
    unsigned long long* counts, float* out, void* stream);
extern "C" int alvrl_vrl_r_hetero_tex(const float* rays, int B, const float* vrls, int N,
                                      const float* tris, int T, const float* med,
                                      const float* mat_table, int M, const float* rt,
                                      const float* density, int nz, int ny, int nx, int uv_steps,
                                      int trilinear, const float* uniforms, unsigned int seed,
                                      int svv, int svs, int short_vrls, int phase_kind,
                                      float* planes, int mode, unsigned long long* counts,
                                      float* out, void* stream);
extern "C" int alvrl_vrl_sum_bvh_tex(const float* rays, int B, const float* vrls, int N,
                                     const float* nodes, int n_nodes, const float* tris, int T,
                                     int depth, const float* med, const float* mat_table, int M,
                                     const float* rt, const float* uniforms, unsigned int seed,
                                     int svv, int svs, int short_vrls, int phase_kind,
                                     float* partial, int n_chunks, float* out,
                                     unsigned long long* counts, void* stream);

namespace {

// pack layouts: ops/pack.py
constexpr int RO = 0, RD = 3, HP = 6, NG = 9, ALB = 12, TAU = 15, VALID = 18;
constexpr int VS = 0, VE = 3, VP = 6, VVALID = 9, VRL_ROWS = 10;
constexpr int TRI_COLS = 9;
// grid packs: NQ + 1 cumulative optical-depth rows after the ray pack's
// (EOD) and the VRL pack's (VOD) rows; the grid medium pack
constexpr int NQ = 16;
constexpr int EOD = 19, VOD = VRL_ROWS, GRID_VRL_ROWS = VOD + NQ + 1;
constexpr int G_SIG_T = 0, G_SIG_S = 3, G_G = 6, G_CHAN = 7, G_BOX0 = 8, G_INV_E = 11,
              G_INDEX_SCALE = 14, G_SCALE = 17, GRID_MED_LEN = 18;

constexpr int RAY_BLOCK = 128;  // threads (rays) per block
constexpr int VRL_CHUNK = 32;   // VRLs per block
constexpr int MAX_TRIS = 1024;  // shared memory: 36 KB of triangles
constexpr int MAX_GRID_Y = 65535;

constexpr float INV_FOURPI = 0.0795774715459476679f;
constexpr float INV_PI = 0.318309886183790672f;
constexpr float RAYLEIGH_NORM = 0.0596831036594607510f;  // 3 / (16 pi)
constexpr float H_EPS = 1e-6f;

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 operator+(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 operator-(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 operator*(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The uniforms of one (ray, VRL) pair, drawn in order d = 0, 1, 2, ...:
// key (seed, 0), counter (b, n, d / 4, 0), word d % 4, (bits >> 8) * 2^-24;
// or this pair's row of the injected (B, N, n_draws) uniforms.
struct PairUniforms {
  const float* injected;  // this pair's row of `uniforms`, or nullptr
  uint32_t b, n, seed;
  uint4 block;
  int block_j;

  __device__ float operator()(int d) {
    if (injected) return injected[d];
    const int j = d >> 2;
    if (j != block_j) {
      block = philox4x32_10(make_uint4(b, n, (uint32_t)j, 0u), seed, 0u);
      block_j = j;
    }
    const int w = d & 3;
    const uint32_t bits = w == 0 ? block.x : w == 1 ? block.y : w == 2 ? block.z : block.w;
    return (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  }
};

// PHASE 0: Henyey-Greenstein, 1: Rayleigh; c = dot(wi, wo)
template <int PHASE>
__device__ __forceinline__ float phase_eval(float g, float c) {
  if (PHASE == 1) return RAYLEIGH_NORM * (1.0f + c * c);
  const float temp = fmaxf(1.0f + g * g + 2.0f * g * c, 1e-12f);
  return INV_FOURPI * (1.0f - g * g) / (temp * sqrtf(temp));
}

// d phase / d g; c = dot(wi, wo). Rayleigh has no g, nor has the
// mixture (PHASE 2), whose components are constants of the pack.
template <int PHASE>
__device__ __forceinline__ float phase_dg(float g, float c) {
  if (PHASE == 1 || PHASE == 2) return 0.0f;
  const float raw = 1.0f + g * g + 2.0f * g * c;
  const float temp = fmaxf(raw, 1e-12f);
  const float dtemp = raw >= 1e-12f ? 2.0f * (g + c) : 0.0f;  // 0 where clamped
  return INV_FOURPI * (-2.0f * g - 1.5f * (1.0f - g * g) * dtemp / temp) / (temp * sqrtf(temp));
}

// The medium pack's extension (ops/pack.py pack_medium), which kernels
// 1, 2 and 5 read in their homogeneous forms: the one sampling rate of
// the single, manual and maximum strategies (0: balance), the mixture's
// component count K, then K (weight, kind, g) triples.
constexpr int MED_LEN = 8, MED_RHO = 8, MED_K = 9, MED_MIX = 10;
constexpr int PHASE_MIXTURE = 4;  // media/phase.py MIXTURE, the PHASE = 2 forms

// The homogeneous medium: sigma_t, sigma_s, g, sampling weight (ops/pack.py);
// built with std::true_type, also the pack's extension (MED_RHO on).
struct Medium {
  float sig_t[3], sig_s[3], g, msw;
  float rho = 0.0f;             // the strategy's one rate; 0: balance
  int k_mix = 0;                // PHASE 2: the mixture's components, at mix
  const float* mix = nullptr;

  __device__ explicit Medium(const float* __restrict__ med)
      : sig_t{med[0], med[1], med[2]}, sig_s{med[3], med[4], med[5]}, g(med[6]), msw(med[7]) {}

  __device__ Medium(const float* __restrict__ med, std::true_type) : Medium(med) {
    rho = med[MED_RHO];
    k_mix = (int)med[MED_K];
    mix = med + MED_MIX;
  }

  // The phase function at c = dot(wi, wo): HG (0) or Rayleigh (1) of g;
  // PHASE 2, the mixture, sum_k w_k phase_k(c) over its components.
  template <int PHASE>
  __device__ __forceinline__ float phase(float c) const {
    if constexpr (PHASE == 2) {
      float s = 0.0f;
      for (int k = 0; k < k_mix; ++k) {
        const float w = __ldg(mix + 3 * k), kind = __ldg(mix + 3 * k + 1);
        s += w * (kind == 1.0f ? phase_eval<1>(0.0f, c) : phase_eval<0>(__ldg(mix + 3 * k + 2), c));
      }
      return s;
    } else {
      return phase_eval<PHASE>(g, c);
    }
  }

  // short-VRL pdfFailure of the VRL segment up to arc length x; e[c] =
  // exp(-sig_t[c] x) under balance, or every e[c] = exp(-rho x) under the
  // strategy's one rate, which the cotangents read (vol_vol_cot)
  __device__ float pdf_failure(float x, float e[3]) const {
    if (rho > 0.0f) {
      const float er = expf(-rho * x);
      e[0] = e[1] = e[2] = er;
      return msw * er + (1.0f - msw);
    }
    e[0] = expf(-sig_t[0] * x);
    e[1] = expf(-sig_t[1] * x);
    e[2] = expf(-sig_t[2] * x);
    const float pf = (e[0] + e[1] + e[2]) * (1.0f / 3.0f);
    return msw * pf + (1.0f - msw);
  }
};

// One eye ray of the ray pack (RAY_ROWS, B); `ok` only for a valid hit.
// Grid packs: eod is this ray's eye cumulative-OD table, NQ + 1 entries
// eod_stride apart (set by the grid kernels).
// alb_any is the vol-surf gate: a non-zero diffuse albedo, or, in the
// material kernels (attach_mat), the hit's smooth flag; mat is the hit's
// material id there.
struct Ray {
  f3 o, d, hp, ng, ee;  // ee: the eye segment hp - o
  float alb[3], tau[3], elen;
  bool ok, alb_any;
  const float* eod;
  int eod_stride, mat;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int B, int b) {
  auto row = [&](int r) { return rays[(size_t)r * B + b]; };
  auto row3 = [&](int r) { return f3{row(r), row(r + 1), row(r + 2)}; };
  Ray ray;
  ray.o = row3(RO);
  ray.d = row3(RD);
  ray.hp = row3(HP);
  ray.ng = row3(NG);
  for (int ch = 0; ch < 3; ++ch) {
    ray.alb[ch] = row(ALB + ch);
    ray.tau[ch] = row(TAU + ch);
  }
  ray.ok = row(VALID) > 0.5f;
  ray.ee = ray.hp - ray.o;
  ray.elen = sqrtf(fmaxf(dot3(ray.ee, ray.ee), 1e-30f));
  ray.alb_any = (ray.alb[0] + ray.alb[1] + ray.alb[2]) > 0.0f;
  return ray;
}

// --- the eye hit's smooth BSDF (the material instantiations, MAT = true,
// of kernels 1, 2 and 5): alvrl_tpu's bsdf/api.py eval_smooth for the
// ported smooth kinds, op for op with the port's plain version
// (bsdf/api.py, bsdf/microfacet.py, bsdf/lobes.py, bsdf/layered.py)

// material pack columns (ops/pack.py pack_materials): kind, albedo (3),
// eta, alpha, alpha_v, distribution, specular (3), exponent, opacity,
// nested, nested2, albedo2 (3), the rough-transmittance table's alpha
// span, the smooth flag (0/1); the ray pack's material-id row (MATID,
// after the RAY_ROWS rows; GRID_MATID in the grid ray pack, after its
// eye-OD rows) and the rough-transmittance tables' shape
constexpr int MT_KIND = 0, MT_ALB = 1, MT_ETA = 4, MT_ALPHA = 5, MT_ALPHA_V = 6, MT_DIST = 7,
              MT_SPEC = 8, MT_EXP = 11, MT_OPAC = 12, MT_NESTED = 13, MT_NESTED2 = 14,
              MT_ALB2 = 15, MT_RT_AMAX = 18, MT_SMOOTH = 19, MAT_COLS = 20;
constexpr int MATID = 19, GRID_MATID = EOD + NQ + 1;
constexpr int MAX_MATS = 256;  // shared memory: 20 KB of material rows
constexpr int RT_COS = 16, RT_ALPHA = 8;
// material kinds (scene/scene.py) and microfacet distributions
constexpr int K_DIFFUSE = 0, K_ROUGH_CONDUCTOR = 4, K_ROUGH_PLASTIC = 5, K_PHONG = 6,
              K_WARD = 7, K_DIFFTRANS = 8, K_PLASTIC = 9, K_MASK = 10, K_MIXTURE = 11,
              K_COATING = 12, K_ROUGH_DIELECTRIC = 16, K_ROUGH_COATING = 17;
constexpr int MF_BECKMANN = 0, MF_GGX = 1, MF_PHONG = 2;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// The material table of a MAT launch: its M rows staged in shared memory
// and the (M, RT_COS, RT_ALPHA) rough-transmittance tables in device
// memory, read through the read-only path. Ids are clamped into [0, M),
// as the plain version clamps them.
struct Mats {
  const float* table;
  const float* rt;
  int M;

  __device__ __forceinline__ int clamp_id(float x) const { return min(max((int)x, 0), M - 1); }
  __device__ __forceinline__ const float* row(int id) const { return table + id * MAT_COLS; }
};

// Host check of a launch's material table: both pointers and 1 <= M <=
// MAX_MATS, or no table (both null, M = 0: a diffuse instantiation).
inline bool mats_ok(const float* mat_table, int M, const float* rt) {
  if (mat_table == nullptr && rt == nullptr && M == 0) return true;
  return mat_table != nullptr && rt != nullptr && M >= 1 && M <= MAX_MATS;
}

// Stage the M material rows at s_mat; returns the table.
__device__ __forceinline__ Mats stage_mats(const float* __restrict__ mat_table, int M,
                                           const float* __restrict__ rt, float* s_mat) {
  for (int i = threadIdx.x; i < M * MAT_COLS; i += blockDim.x) s_mat[i] = mat_table[i];
  return Mats{s_mat, rt, M};
}

// The eye ray of a MAT kernel: its hit's material id (row MATID of the
// homogeneous ray pack, GRID_MATID of the grid one), and the vol-surf
// gate set to the material's smooth flag (in place of a non-zero diffuse
// albedo).
template <bool GRID = false>
__device__ __forceinline__ void attach_mat(Ray& ray, const float* __restrict__ rays, int B, int b,
                                           const Mats& mats) {
  ray.mat = mats.clamp_id(rays[(size_t)(GRID ? GRID_MATID : MATID) * B + b]);
  ray.alb_any = mats.row(ray.mat)[MT_SMOOTH] > 0.5f;
}

__device__ __forceinline__ float sgn(float x) { return (float)(x > 0.0f) - (float)(x < 0.0f); }

__device__ __forceinline__ f3 normalize3(f3 v) {
  return v * (1.0f / fmaxf(sqrtf(fmaxf(dot3(v, v), 0.0f)), 1e-20f));
}

// Unpolarized Fresnel reflectance, cos_i clamped to [0, 1], eta int/ext.
__device__ __forceinline__ float fresnel_diel(float cos_i, float eta) {
  cos_i = fminf(fmaxf(cos_i, 0.0f), 1.0f);
  const float sin_t2 = (1.0f / (eta * eta)) * fmaxf(1.0f - cos_i * cos_i, 0.0f);
  const float cos_t = sqrtf(fmaxf(1.0f - sin_t2, 0.0f));
  const float rs = (cos_i - eta * cos_t) / fmaxf(cos_i + eta * cos_t, 1e-12f);
  const float rp = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-12f);
  return sin_t2 >= 1.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
}

__device__ __forceinline__ float phong_exponent(float a) {
  return fmaxf(2.0f / fmaxf(a * a, 1e-8f) - 2.0f, 0.0f);
}

// microfacet.py mf_d: the NDF of distribution `dist`
__device__ float mf_d(int dist, f3 h, float au, float av) {
  const float ct = h.z;
  const float ct2 = fmaxf(ct * ct, 1e-12f);
  const float x2 = h.x * h.x, y2 = h.y * h.y;
  const float au2 = fmaxf(au * au, 1e-8f), av2 = fmaxf(av * av, 1e-8f);
  const float bexp = (x2 / au2 + y2 / av2) / ct2;
  float d;
  if (dist == MF_BECKMANN) {
    d = expf(-bexp) / (PI_F * au * av * ct2 * ct2);
  } else if (dist == MF_PHONG) {
    const float e_u = phong_exponent(au), e_v = phong_exponent(av);
    const float st2 = fmaxf(x2 + y2, 1e-12f);
    const float e = x2 + y2 > 1e-12f ? (x2 * e_u + y2 * e_v) / st2 : e_u;
    d = sqrtf((e_u + 2.0f) * (e_v + 2.0f)) / TWO_PI_F * powf(fmaxf(ct, 1e-9f), e);
  } else {
    const float root = (1.0f + bexp) * ct2;
    d = 1.0f / fmaxf(PI_F * au * av * root * root, 1e-20f);
  }
  return (ct > 0.0f && d * ct >= 1e-20f) ? d : 0.0f;
}

// microfacet.py mf_g1: Smith masking of one direction
__device__ float mf_g1(int dist, f3 v, f3 h, float au, float av) {
  const float ct = v.z;
  if (!(dot3(v, h) * ct > 0.0f)) return 0.0f;
  const float tan_t = sqrtf(fmaxf(1.0f - ct * ct, 0.0f)) / fmaxf(fabsf(ct), 1e-9f);
  if (tan_t < 1e-9f) return 1.0f;
  float alpha = au;
  if (1.0f - ct * ct > 1e-12f) {
    const float st2 = fmaxf(1.0f - ct * ct, 1e-12f);
    alpha = sqrtf(v.x * v.x / st2 * au * au + v.y * v.y / st2 * av * av);
  }
  if (dist == MF_GGX) {
    const float root = alpha * tan_t;
    return 2.0f / (1.0f + sqrtf(1.0f + root * root));
  }
  const float a = 1.0f / fmaxf(alpha * tan_t, 1e-9f), a2 = a * a;
  return a >= 1.6f ? 1.0f : (3.535f * a + 2.181f * a2) / (1.0f + 2.276f * a + 2.577f * a2);
}

// microfacet.py eval_rough_conductor_d (f0 the tint) and
// eval_rough_plastic_d (f0 0.04 over a Lambertian albedo)
__device__ void eval_rough_conductor(f3 wi, f3 wo, int dist, float au, float av,
                                     const float f0[3], float f[3]) {
  const float ci = wi.z;
  const f3 h = normalize3(wi + wo);
  const float dg = mf_d(dist, h, au, av) * (mf_g1(dist, wi, h, au, av) * mf_g1(dist, wo, h, au, av)) /
                   fmaxf(4.0f * ci, 1e-9f);
  const float c = fminf(fmaxf(1.0f - dot3(wi, h), 0.0f), 1.0f);
  const float c5 = c * c * c * c * c;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) f[ch] = (f0[ch] + (1.0f - f0[ch]) * c5) * dg;
}

// microfacet.py eval_rough_dielectric, radiance mode
__device__ float eval_rough_dielectric(f3 wi, f3 wo, float eta, int dist, float au, float av) {
  const float ci = wi.z, co = wo.z;
  const bool reflect = ci * co > 0.0f;
  const float eta_i = ci > 0.0f ? 1.0f : eta, eta_o = ci > 0.0f ? eta : 1.0f;
  f3 h = reflect ? normalize3(wi + wo) : normalize3(wi * eta_i + wo * eta_o);
  h = h * sgn(h.z);
  const float d = mf_d(dist, h, au, av);
  const float g = mf_g1(dist, wi, h, au, av) * mf_g1(dist, wo, h, au, av);
  const float wih = dot3(wi, h), woh = dot3(wo, h);
  const float cim = ci > 0.0f ? wih : -wih;
  const float f = fresnel_diel(fabsf(cim), cim >= 0.0f ? eta : 1.0f / eta);
  if (reflect) return f * d * g / fmaxf(4.0f * fabsf(ci), 1e-9f);
  const float denom = eta_i * wih + eta_o * woh;
  if (!(fabsf(denom) > 1e-9f)) return 0.0f;
  const float val = fabsf(wih * woh) / fmaxf(fabsf(ci * co), 1e-9f) * eta_o * eta_o *
                    (1.0f - f) * d * g / fmaxf(denom * denom, 1e-12f) * fabsf(co);
  const float r = eta_i / eta_o;
  return val * (r * r);
}

// f cos_o of a leaf kind's smooth component (bsdf/api.py
// _leaf_eval_local) in the local frame; 0 for the other kinds
__device__ void leaf_eval(const float* r, f3 wi, f3 wo, float f[3]) {
  const int kind = (int)r[MT_KIND];
  const float ci = wi.z, co = wo.z;
  const float* alb = r + MT_ALB;
  const int dist = (int)r[MT_DIST];
  const float au = r[MT_ALPHA], av = r[MT_ALPHA_V];
  f[0] = f[1] = f[2] = 0.0f;
  switch (kind) {
    case K_DIFFUSE: {
      const float c = fmaxf(co, 0.0f) / PI_F;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = alb[ch] * c;
      break;
    }
    case K_ROUGH_CONDUCTOR:
      if (ci > 0.0f && co > 0.0f) eval_rough_conductor(wi, wo, dist, au, av, alb, f);
      break;
    case K_ROUGH_PLASTIC:
      if (ci > 0.0f && co > 0.0f) {
        const float f0[3] = {0.04f, 0.04f, 0.04f};
        eval_rough_conductor(wi, wo, dist, au, av, f0, f);
        const float c = fminf(fmaxf(co, 0.0f), 1.0f) / PI_F;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[ch] = f[ch] + alb[ch] * c;
      }
      break;
    case K_PHONG:
      if (ci > 0.0f && co > 0.0f) {
        const float ex = r[MT_EXP];
        const float cos_a = fminf(fmaxf(-wi.x * wo.x - wi.y * wo.y + wi.z * wo.z, 0.0f), 1.0f);
        const float s = (ex + 2.0f) / TWO_PI_F * powf(cos_a, ex);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[ch] = (alb[ch] * INV_PI + r[MT_SPEC + ch] * s) * co;
      }
      break;
    case K_WARD:
      if (ci > 1e-4f && co > 1e-4f) {
        const f3 h = wi + wo;
        const float hz2 = fmaxf(h.z * h.z, 1e-12f);
        const float hu = h.x / au, hv = h.y / av;
        const float expo = expf(-(hu * hu + hv * hv) / hz2);
        const float s = expo / (4.0f * PI_F * au * av * sqrtf(fmaxf(ci * co, 1e-12f)));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[ch] = (alb[ch] * INV_PI + r[MT_SPEC + ch] * s) * co;
      }
      break;
    case K_DIFFTRANS:
      if (ci * co < 0.0f) {
        const float c = fabsf(co) * INV_PI;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[ch] = alb[ch] * c;
      }
      break;
    case K_PLASTIC:
      if (ci > 0.0f && co > 0.0f) {
        const float eta = r[MT_ETA];
        const float c = (1.0f - fresnel_diel(ci, eta)) * (1.0f - fresnel_diel(co, eta)) * INV_PI * co;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[ch] = alb[ch] * c;
      }
      break;
    case K_ROUGH_DIELECTRIC: {
      const float v = eval_rough_dielectric(wi, wo, r[MT_ETA], dist, au, av);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = alb[ch] * v;
      break;
    }
    default:
      break;
  }
}

// layered.py refract_z: the tangential part scaled by inv_eta; false if
// it does not refract
__device__ __forceinline__ bool refract_z(f3 w, float inv_eta, f3& out) {
  const float x = w.x * inv_eta, y = w.y * inv_eta;
  const float z2 = 1.0f - x * x - y * y;
  out = {x, y, sgn(w.z) * sqrtf(fmaxf(z2, 0.0f))};
  return z2 > 0.0f;
}

// microfacet.py rough_transmittance_b: material id's table, bilinear at
// (|cos_i|, alpha / alpha_max)
__device__ float rough_t(const Mats& mats, int id, float cos_i, float alpha, float amax) {
  const float gx = fminf(fmaxf(fabsf(cos_i), 0.0f), 1.0f) * RT_COS - 1.0f;
  const float gy = fminf(fmaxf(alpha / amax, 0.0f), 1.0f) * RT_ALPHA - 1.0f;
  const int x0 = min(max((int)floorf(gx), 0), RT_COS - 2);
  const int y0 = min(max((int)floorf(gy), 0), RT_ALPHA - 2);
  const float fx = fminf(fmaxf(gx - (float)x0, 0.0f), 1.0f);
  const float fy = fminf(fmaxf(gy - (float)y0, 0.0f), 1.0f);
  const float* t = mats.rt + (size_t)id * (RT_COS * RT_ALPHA) + x0 * RT_ALPHA + y0;
  const float t00 = __ldg(t), t01 = __ldg(t + 1), t10 = __ldg(t + RT_ALPHA),
              t11 = __ldg(t + RT_ALPHA + 1);
  return (t00 * (1.0f - fx) + t10 * fx) * (1.0f - fy) + (t01 * (1.0f - fx) + t11 * fx) * fy;
}

// The BSDF eval times cos(theta_o) of the smooth components of material
// `mat` at the shading normal ng (bsdf/api.py eval_smooth): wi_w points
// from the surface to the eye, wo_w to the light. The local frame is
// core/math.py build_frame's (Duff et al.), which the anisotropic Ward
// and microfacet lobes depend on. The wrappers resolve one level: MASK
// (opacity times the nested eval), MIXTURE (the convex mix of nested and
// nested2), COATING (the nested eval at the refracted directions,
// Fresnel-attenuated both ways, with the slab's absorption and the
// measure factor) and ROUGH_COATING (its glossy coat reflection plus
// the nested eval attenuated by the rough transmittance both ways).
// Not inlined: one copy serves a kernel's samples; its arguments and
// result travel in registers.
__device__ __noinline__ f3 eval_smooth(Mats mats, int mat, f3 ng, f3 wi_w, f3 wo_w) {
  float f[3];
  const float sign = ng.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + ng.z);
  const float b = ng.x * ng.y * a;
  const f3 s = {1.0f + sign * ng.x * ng.x * a, sign * b, -sign * ng.x};
  const f3 t = {b, sign + ng.y * ng.y * a, -ng.y};
  const f3 wi = {dot3(wi_w, s), dot3(wi_w, t), dot3(wi_w, ng)};
  const f3 wo = {dot3(wo_w, s), dot3(wo_w, t), dot3(wo_w, ng)};
  const float* r = mats.row(mat);
  const int kind = (int)r[MT_KIND];
  const float* r1 = mats.row(mats.clamp_id(r[MT_NESTED]));
  if (kind == K_MASK || kind == K_MIXTURE) {
    const float w = r[MT_OPAC];
    leaf_eval(r1, wi, wo, f);
    if (kind == K_MASK) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = w * f[ch];
    } else {
      float f2[3];
      leaf_eval(mats.row(mats.clamp_id(r[MT_NESTED2])), wi, wo, f2);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) f[ch] = w * f[ch] + (1.0f - w) * f2[ch];
    }
    return {f[0], f[1], f[2]};
  }
  if (kind != K_COATING && kind != K_ROUGH_COATING) {
    leaf_eval(r, wi, wo, f);
    return {f[0], f[1], f[2]};
  }
  const float eta = r[MT_ETA];
  f3 wi_p, wo_p;
  const bool ok_i = refract_z(wi, 1.0f / eta, wi_p);
  const bool ok_o = refract_z(wo, 1.0f / eta, wo_p);
  const float jac = fabsf(wo.z) / fmaxf(fabsf(wo_p.z), 1e-6f) / (eta * eta);
  const float inv = 1.0f / fmaxf(fabsf(wi_p.z), 1e-6f) + 1.0f / fmaxf(fabsf(wo_p.z), 1e-6f);
  const float th_inv = r[MT_EXP] * inv;
  float spec = 0.0f, att;
  if (kind == K_COATING) {
    att = (1.0f - fresnel_diel(fabsf(wi.z), eta)) * (1.0f - fresnel_diel(fabsf(wo.z), eta)) * jac;
  } else {
    const float au = r[MT_ALPHA], amax = r[MT_RT_AMAX];
    const int dist = (int)r[MT_DIST];
    if (wi.z * wo.z > 0.0f) {
      f3 h = normalize3(wi + wo);
      h = h * sgn(h.z + 1e-20f);
      const float d = mf_d(dist, h, au, au);
      const float g = mf_g1(dist, wi, h, au, au) * mf_g1(dist, wo, h, au, au);
      spec = fresnel_diel(fabsf(dot3(wi, h)), eta) * d * g / fmaxf(4.0f * fabsf(wi.z), 1e-9f);
    }
    att = rough_t(mats, mat, wi.z, au, amax) * rough_t(mats, mat, wo.z, au, amax) * jac;
  }
  if (!(ok_i && ok_o)) return {spec, spec, spec};
  leaf_eval(r1, wi_p, wo_p, f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) f[ch] = f[ch] * att * expf(-r[MT_ALB2 + ch] * th_inv) + spec;
  return {f[0], f[1], f[2]};
}

// Stage all T triangles and the block's chunk of VRLs (n_rows rows of
// the pack, the chunk's `chunk` columns zero-padded to VRL_CHUNK) in
// shared memory; returns the chunk's VRL count.
__device__ __forceinline__ int stage_block(const float* __restrict__ tris, int T,
                                           const float* __restrict__ vrls, int N, int n0,
                                           float* s_tri, float* s_vrl,
                                           int n_rows = VRL_ROWS, int chunk = VRL_CHUNK) {
  const int nc = min(chunk, N - n0);
  for (int i = threadIdx.x; i < T * TRI_COLS; i += blockDim.x) s_tri[i] = tris[i];
  for (int i = threadIdx.x; i < n_rows * VRL_CHUNK; i += blockDim.x) {
    const int r = i / VRL_CHUNK, c = i % VRL_CHUNK;
    s_vrl[i] = c < nc ? vrls[(size_t)r * N + n0 + c] : 0.0f;
  }
  return nc;
}

// Is a clustered table's column (VRL id, weight w) evaluated? Its id
// lies in [0, N), its VRL is valid and its weight is > 0.
__device__ __forceinline__ bool column_valid(const float* __restrict__ vrls, int N, int id,
                                             float w) {
  return id >= 0 && id < N && vrls[(size_t)VVALID * N + id] > 0.5f && w > 0.0f;
}

// Stage columns c0 .. c0 + VRL_CHUNK of one clustered table row (ids,
// ws: the row's C VRL ids and weights) in shared memory, each gathered
// by id from the full pack (n_rows rows of N columns) and zero-padded to
// VRL_CHUNK: the weight folded into the power rows, VVALID set to 1
// where column_valid (an id outside [0, N) stages an all-zero column),
// the id into s_id. The clustered sum and its VJP both stage through
// here, so the replay reads what the forward read. Returns the piece's
// column count.
__device__ __forceinline__ int stage_table_piece(const float* __restrict__ vrls, int N,
                                                 int n_rows, const int* __restrict__ ids,
                                                 const float* __restrict__ ws, int C, int c0,
                                                 float* s_vrl, int* s_id) {
  const int nc = min(VRL_CHUNK, C - c0);
  for (int i = threadIdx.x; i < n_rows * VRL_CHUNK; i += blockDim.x) {
    const int r = i / VRL_CHUNK, c = i % VRL_CHUNK;
    const int id = c < nc ? ids[c0 + c] : -1;
    const float w = c < nc ? ws[c0 + c] : 0.0f;
    float v = 0.0f;
    if (id >= 0 && id < N) {
      v = vrls[(size_t)r * N + id];
      if (r >= VP && r < VP + 3) v *= w;
      if (r == VVALID) v = column_valid(vrls, N, id, w) ? 1.0f : 0.0f;
    }
    s_vrl[i] = v;
    if (r == 0) s_id[c] = id;
  }
  return nc;
}

// A shadow segment p -> q: its unit direction u and the open interval
// (lo, hi) of arc length it tests (ends shrunk by 1e-3 * max(|q - p|, 1)).
struct Segment {
  f3 p, u;
  float lo, hi;
};

__device__ __forceinline__ Segment make_segment(f3 p, f3 q) {
  const f3 dd = q - p;
  const float len2 = dot3(dd, dd);
  const float idist = 1.0f / sqrtf(fmaxf(len2, 1e-30f));
  const float dist = len2 * idist;
  Segment s;
  s.p = p;
  s.u = dd * idist;
  s.lo = 1e-3f * fmaxf(dist, 1.0f);
  s.hi = dist - s.lo;
  return s;
}

// Does the triangle (p0, e1 = p1 - p0, e2 = p2 - p0) block segment s?
// The division-free Wald test; both occlusion policies (FlatTris here,
// BvhTris in vrl_sum_bvh.cu) call it, so they agree bit for bit.
__device__ __forceinline__ bool wald_hit(const Segment& s, f3 p0, f3 e1, f3 e2) {
  const f3 pv = cross3(s.u, e2);
  const float det = dot3(e1, pv);
  const float sgn = det >= 0.0f ? 1.0f : -1.0f;
  const float adet = det * sgn;
  const f3 tv = s.p - p0;
  const float uu = dot3(tv, pv) * sgn;
  const f3 qv = cross3(tv, e1);
  const float vv = dot3(s.u, qv) * sgn;
  const float tt = dot3(e2, qv) * sgn;
  float mn = fminf(uu, vv);
  mn = fminf(mn, adet - (uu + vv));
  mn = fminf(mn, tt - s.lo * adet);
  mn = fminf(mn, s.hi * adet - tt);
  mn = fminf(mn, adet - 1e-12f);
  return mn > 0.0f;
}

// Any of the T triangles staged at s_tri blocking the open segment
// p -> q? One sweep, ending at the first blocker.
__device__ bool occluded(const float* __restrict__ s_tri, int T, f3 p, f3 q) {
  const Segment s = make_segment(p, q);
  for (int t = 0; t < T; ++t) {
    const float* tr = s_tri + t * TRI_COLS;
    if (wald_hit(s, {tr[0], tr[1], tr[2]}, {tr[3], tr[4], tr[5]}, {tr[6], tr[7], tr[8]}))
      return true;
  }
  return false;
}

// The shadow test of the estimator is a policy: occl(p, q) is true when
// the open segment p -> q is blocked. FlatTris sweeps the triangles a
// block staged in shared memory (every kernel but vrl_sum_bvh.cu's,
// whose BvhTris walks a BVH in device memory).
struct FlatTris {
  const float* s_tri;
  int T;

  __device__ __forceinline__ bool operator()(f3 p, f3 q) const { return occluded(s_tri, T, p, q); }
};

// The flat sweep with a plane pre-reject (kernel 1's homogeneous
// instantiations, vrl_sum.cu): each triangle comes as PLANE_F4 float4s
// of a plane pack (vrl_sum.cu plane_pack_kernel; plain twin
// ops/vrl_sum.py:plane_pack),
//   (n.xyz, off), (k, k0, p0.x, p0.y), (p0.z, e1.xyz), (e2.xyz, 0),
// with n = fl(e1 x e2) and off = fl(n . p0) the triangle's plane and k =
// PLANE_MARGIN |e1|_inf |e2|_inf, k0 = k |p0|_inf rounded up. A triangle
// is skipped, without its Wald test, when the segment's two tested ends
// a = p + lo u and b = p + hi u lie on one side of its plane by more than
// the margin M = k S + k0, S = |p|_inf + max(|lo|, |hi|); the rest go
// through wald_hit unchanged. The skip implies wald_hit = false, so the
// sweep decides as FlatTris does on every segment:
//   * In exact arithmetic, with N = e1 x e2 and sigma(x) = N . (x - p0),
//     wald_hit's last two conditions read tt - lo adet = sgn sigma(a) > 0
//     and hi adet - tt = -sgn sigma(b) > 0 (tt = N . (p - p0), det =
//     -N . u, sgn the sign it takes for det): the ends lie strictly on
//     opposite sides of the plane. If sigma(a) and sigma(b) have one sign,
//     one of the two is negative, whichever sgn wald_hit takes.
//   * wald_hit computes those two quantities in float32. Counting each
//     rounding (unit eps = 2^-24; |N|_1 <= 6 E1 E2 with E1 = |e1|_inf,
//     E2 = |e2|_inf, P = |p|_inf, P0 = |p0|_inf, L = max(|lo|, |hi|)):
//     tv = p - p0 rounded (6 eps E1 E2 (P + P0)), the cross and dot
//     products of tt (30 eps E1 E2 (P + P0)) and of det (30 eps E1 E2 L
//     after the product with lo or hi), that product and the final
//     difference (12 eps E1 E2 (P + P0 + L)): each lies within 48 eps E1
//     E2 (P + P0 + L) of its exact value, first order.
//   * The pre-reject's own sigma lies within 42 eps E1 E2 (P + P0 + L)
//     of the exact sigma: a and b rounded twice per component (12 eps),
//     n rounded (6 eps), off rounded (6 eps), the three fused
//     multiply-adds (18 eps).
//   * So a skip needs |sigma| > 90 eps E1 E2 (P + P0 + L) = 5.4e-6 E1 E2
//     (P + P0 + L) at both ends; the margin is PLANE_MARGIN = 2^-14
//     (6.1e-5) of the same, 11 times that, with k, k0 rounded up and the
//     margin's own two roundings far inside the slack. A NaN anywhere
//     fails every comparison and skips nothing; a degenerate triangle
//     (n = 0) has sigma = 0 and is never skipped.
// The checking instantiation (MODE 1) runs both decisions on every
// triangle, decides with the Wald test alone (FlatTris' decision) and
// counts, per thread: segments, triangles the old sweep tests (up to its
// first blocker), those of them the pre-reject skips, triangles skipped
// that the Wald test finds blocking, and segments whose two decisions
// differ; the last two must be 0. MODE 2 is the sweep of the plane pack
// without the pre-reject (timing only). tris: the block's copy of the
// pack in shared memory, which every thread of a warp reads at the same
// float4 in the pre-reject (a broadcast).
constexpr int PLANE_F4 = 4;  // float4s per triangle of the plane pack
constexpr float PLANE_MARGIN = 6.103515625e-05f;  // 2^-14

struct CheckCounts {
  uint32_t segments, considered, skipped, bad_tris, bad_segments;
};

template <int MODE>
struct PlaneTris {
  const float4* tris;
  int T;
  CheckCounts* counts;

  // does the pre-reject skip the triangle whose pack starts at float4 i
  // (km = its second float4)?
  __device__ __forceinline__ bool skips(int i, float4 km, f3 a, f3 b, float span) const {
    const float4 pl = tris[i];
    const float sa = fmaf(pl.x, a.x, fmaf(pl.y, a.y, fmaf(pl.z, a.z, -pl.w)));
    const float sb = fmaf(pl.x, b.x, fmaf(pl.y, b.y, fmaf(pl.z, b.z, -pl.w)));
    const float mg = fmaf(km.x, span, km.y);
    return (sa > mg && sb > mg) || (sa < -mg && sb < -mg);
  }

  // the Wald test of the triangle whose pack starts at float4 i
  __device__ __forceinline__ bool hits(const Segment& s, int i) const {
    const float4 r1 = tris[i + 1], r2 = tris[i + 2], r3 = tris[i + 3];
    return wald_hit(s, {r1.z, r1.w, r2.x}, {r2.y, r2.z, r2.w}, {r3.x, r3.y, r3.z});
  }

  __device__ bool operator()(f3 p, f3 q) const {
    const Segment s = make_segment(p, q);
    if (MODE == 2) {  // every triangle's Wald test
      for (int t = 0; t < T; ++t)
        if (hits(s, PLANE_F4 * t)) return true;
      return false;
    }
    const f3 a = s.p + s.u * s.lo, b = s.p + s.u * s.hi;
    const float span = fmaxf(fmaxf(fabsf(s.p.x), fabsf(s.p.y)), fabsf(s.p.z)) +
                       fmaxf(fabsf(s.lo), fabsf(s.hi));
    if (MODE == 0) {
      // 32 triangles at a time: the pre-reject of each into a mask of the
      // ones it keeps (no branch, so a warp's lanes stay together), then
      // the Wald test of the kept ones in triangle order, to the first
      // blocker: a lane tests only its own, not every triangle some lane
      // of its warp keeps
      for (int t0 = 0; t0 < T; t0 += 32) {
        const int n = min(32, T - t0);
        uint32_t kept = 0u;
        for (int k = 0; k < n; ++k) {
          const int i = PLANE_F4 * (t0 + k);
          kept |= (uint32_t)!skips(i, tris[i + 1], a, b, span) << k;
        }
        while (kept) {
          const int k = __ffs(kept) - 1;
          kept &= kept - 1u;
          if (hits(s, PLANE_F4 * (t0 + k))) return true;
        }
      }
      return false;
    }
    bool old = false, now = false;
    ++counts->segments;
    for (int t = 0; t < T; ++t) {
      const int i = PLANE_F4 * t;
      const bool skip = skips(i, tris[i + 1], a, b, span);
      const bool hit = hits(s, i);
      if (!old) {  // the old sweep ends at its first blocker
        ++counts->considered;
        if (skip) ++counts->skipped;
      }
      if (skip && hit) ++counts->bad_tris;
      old = old || hit;
      now = now || (hit && !skip);
    }
    if (old != now) ++counts->bad_segments;
    return old;
  }
};

// PlaneTris' modes: the pre-reject; the checking instantiation, which
// counts; no pre-reject (timing only). A checking launch adds its
// threads' CheckCounts, in their order, to N_CHECK totals.
constexpr int MODE_SUM = 0, MODE_CHECK = 1, MODE_NO_REJECT = 2;
constexpr int N_CHECK = 5;

// The sweep of the triangles a block stages in shared memory: the plane
// pack swept by PlaneTris<MODE> (PLANES), or the triangles, TRI_COLS
// floats each, swept by FlatTris.
template <bool PLANES, int MODE = MODE_SUM>
using Sweep = std::conditional_t<PLANES, PlaneTris<MODE>, FlatTris>;

// the floats of shared memory that T triangles take in that sweep
template <bool PLANES>
__host__ __device__ constexpr size_t sweep_floats(int T) {
  return (size_t)T * (PLANES ? 4 * PLANE_F4 : TRI_COLS);
}

// Stage the T triangles `tris` (the plane pack if PLANES, else TRI_COLS
// floats each) at s_tri, which a plane pack needs float4-aligned;
// returns the sweep over them, counting into *counts in MODE_CHECK.
template <bool PLANES, int MODE = MODE_SUM>
__device__ __forceinline__ Sweep<PLANES, MODE> stage_sweep(const float* __restrict__ tris, int T,
                                                           float* s_tri,
                                                           CheckCounts* counts = nullptr) {
  if constexpr (PLANES) {
    const float4* planes = reinterpret_cast<const float4*>(tris);
    float4* s_planes = reinterpret_cast<float4*>(s_tri);
    for (int i = threadIdx.x; i < T * PLANE_F4; i += blockDim.x) s_planes[i] = planes[i];
    return PlaneTris<MODE>{s_planes, T, counts};
  } else {
    for (int i = threadIdx.x; i < T * TRI_COLS; i += blockDim.x) s_tri[i] = tris[i];
    return FlatTris{s_tri, T};
  }
}

// A checking launch's thread adds its counts to counts[N_CHECK].
__device__ __forceinline__ void add_check_counts(const CheckCounts& cnt,
                                                 unsigned long long* counts) {
  const uint32_t all[N_CHECK] = {cnt.segments, cnt.considered, cnt.skipped, cnt.bad_tris,
                                 cnt.bad_segments};
#pragma unroll
  for (int i = 0; i < N_CHECK; ++i) atomicAdd(counts + i, (unsigned long long)all[i]);
}

// Equi-angular (Kulla-Fajardo) sampling of a point at arc length `arc`
// along the segment a + t * dir, t in [0, len], around point x.
__device__ __forceinline__ void kulla(f3 a, f3 dir, float len, f3 x, float u, float& arc,
                                      float& pdf) {
  const float dot_pr = dot3(dir, x - a);
  const f3 dd = x - (a + dir * dot_pr);
  const float dis = fmaxf(sqrtf(dot3(dd, dd)), H_EPS);
  const float dist_ai = fabsf(dot_pr);
  const float dist_ib = fabsf(len - dot_pr);
  float angle_a = atanf(dist_ai / dis);
  float angle_b = atanf(dist_ib / dis);
  const bool pos = dot_pr > 0.0f;
  if (pos) angle_a = -angle_a;
  if (pos && dist_ai > len) angle_b = -angle_b;
  const float t = dis * tanf((1.0f - u) * angle_a + u * angle_b);
  const float span = angle_b - angle_a;
  pdf = fabsf(span) > 1e-12f ? dis / fmaxf(span * (dis * dis + t * t), 1e-30f) : 0.0f;
  arc = dot_pr + t;
}

// Parameter tc in [0, 1] of the point of segment (s, s + v) closest to
// segment (o, o + u), and the distance between the closest points.
__device__ __forceinline__ void seg_seg_closest(f3 o, f3 u, f3 s, f3 v, float& tc, float& h) {
  const f3 w = o - s;
  const float a = dot3(u, u), b = dot3(u, v), c = dot3(v, v);
  const float d = dot3(u, w), e = dot3(v, w);
  const float denom = a * c - b * b;
  const bool par = denom < 1e-9f * a * c + 1e-30f;
  float s_n = par ? 0.0f : b * e - c * d;
  float s_d = par ? 1.0f : denom;
  float t_n = par ? e : a * e - b * d;
  float t_d = par ? c : denom;
  const bool below = s_n < 0.0f, above = s_n > s_d;
  t_n = below ? e : (above ? e + b : t_n);
  t_d = (below || above) ? c : t_d;
  s_n = below ? 0.0f : (above ? s_d : s_n);
  const bool t_below = t_n < 0.0f, t_above = t_n > t_d;
  const float s_lo = fminf(fmaxf(-d, 0.0f), a);
  const float s_hi = fminf(fmaxf(-d + b, 0.0f), a);
  s_n = t_below ? s_lo : (t_above ? s_hi : s_n);
  s_d = (t_below || t_above) ? fmaxf(a, 1e-30f) : s_d;
  t_n = t_below ? 0.0f : (t_above ? t_d : t_n);
  const float sc = s_n / fmaxf(s_d, 1e-30f);
  tc = t_n / fmaxf(t_d, 1e-30f);
  const f3 dp = (o + u * sc) - (s + v * tc);
  h = sqrtf(fmaxf(dot3(dp, dp), 0.0f));
}

// A VRL (from column c of the staged chunk) and what its samples against
// one eye ray share: the inverse-distance sampler's setup. Grid packs:
// vod is the VRL's cumulative-OD column in shared memory, NQ + 1
// entries VRL_CHUNK apart (set by pair_at<true>).
struct VrlPair {
  f3 s, uv;  // start, unit direction
  float pw[3], vlen, ivl, sin_safe, h, arc_h, a0, a1;
  bool near_par;
  const float* vod;
};

__device__ __forceinline__ VrlPair pair_setup(const Ray& ray, const float* s_vrl, int c) {
  auto vrl = [&](int r) { return s_vrl[r * VRL_CHUNK + c]; };
  VrlPair p;
  p.s = {vrl(VS), vrl(VS + 1), vrl(VS + 2)};
  const f3 vd = f3{vrl(VE), vrl(VE + 1), vrl(VE + 2)} - p.s;
  for (int ch = 0; ch < 3; ++ch) p.pw[ch] = vrl(VP + ch);
  p.vlen = sqrtf(fmaxf(dot3(vd, vd), 1e-30f));
  p.ivl = 1.0f / p.vlen;
  p.uv = vd * p.ivl;
  float tc, h_close;
  seg_seg_closest(ray.o, ray.ee, p.s, vd, tc, h_close);
  const float cos_theta = dot3(ray.d, p.uv);
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  p.near_par = sin_theta < 1e-4f;
  p.sin_safe = fmaxf(sin_theta, 1e-4f);
  p.h = fmaxf(h_close, H_EPS);
  p.arc_h = tc * p.vlen;  // closest point's arc position on the VRL
  p.a0 = asinhf(-p.arc_h / p.h * p.sin_safe);
  p.a1 = asinhf((p.vlen - p.arc_h) / p.h * p.sin_safe);
  return p;
}

template <bool GRID>
__device__ __forceinline__ VrlPair pair_at(const Ray& ray, const float* s_vrl, int c) {
  VrlPair p = pair_setup(ray, s_vrl, c);
  if constexpr (GRID) p.vod = s_vrl + VOD * VRL_CHUNK + c;
  return p;
}

// The geometry of one unoccluded sample: the phase cosines, the
// denominator max(pdf * d_uv^2, 1e-30), the VRL arc length d_sv that the
// short-VRL pdfFailure reads, and the transmittance path length; for the
// grid medium also the points U (vol-vol) and V, |U - V| and the eye arc
// length |E - U| (vol-vol).
struct Sample {
  float c_u, c_v, cos_o, den, d_sv, path, d_uv, d_eu;
  f3 up, vp, vu;  // vu: the unit direction V -> hit (vol-surf)
};

// Vol-vol: V on the VRL ~ inverse distance to the eye ray, U on the eye
// ray ~ equi-angular around V. False if the sample is dropped.
template <class Occl>
__device__ __forceinline__ bool vol_vol_sample(const Ray& ray, const VrlPair& p, float u1, float u2,
                                               const Occl& occl, Sample& sm) {
  float arc_v, pdf_v;
  if (p.near_par) {
    arc_v = u1 * p.vlen;
    pdf_v = p.ivl;
  } else {
    const float new_v = p.h * sinhf(p.a0 + u1 * (p.a1 - p.a0)) / p.sin_safe;
    const float inv_dist =
        1.0f / sqrtf(fmaxf(p.h * p.h + new_v * new_v * p.sin_safe * p.sin_safe, 1e-30f));
    const float denom = fmaxf((p.a1 - p.a0) / p.sin_safe, 1e-30f);
    arc_v = new_v + p.arc_h;
    pdf_v = inv_dist / denom;
  }
  const f3 vp = p.s + p.uv * arc_v;
  float arc_u, pdf_u;
  kulla(ray.o, ray.d, ray.elen, vp, u2, arc_u, pdf_u);
  const f3 up = ray.o + ray.d * arc_u;
  const float pdf = pdf_v * pdf_u;
  const f3 duv = up - vp;
  const float d_uv2 = dot3(duv, duv);
  if (!(d_uv2 > 0.0f && pdf > 0.0f)) return false;
  if (occl(up, vp)) return false;
  const float d_uv = sqrtf(fmaxf(d_uv2, 1e-30f));
  const f3 vu = duv * (1.0f / d_uv);
  sm.c_u = dot3(vu, ray.d);
  sm.c_v = -dot3(p.uv, vu);
  sm.den = fmaxf(pdf * d_uv2, 1e-30f);
  sm.d_sv = fabsf(arc_v);
  sm.d_eu = fabsf(arc_u);
  sm.path = sm.d_eu + d_uv + sm.d_sv;
  sm.d_uv = d_uv;
  sm.up = up;
  sm.vp = vp;
  return true;
}

// Vol-surf: V on the VRL ~ equi-angular around the eye ray's hit point.
template <class Occl>
__device__ __forceinline__ bool vol_surf_sample(const Ray& ray, const VrlPair& p, float u1,
                                                const Occl& occl, Sample& sm) {
  float arc_v, pdf_v;
  kulla(p.s, p.uv, p.vlen, ray.hp, u1, arc_v, pdf_v);
  const f3 vp = p.s + p.uv * arc_v;
  const f3 duv = ray.hp - vp;
  const float d_uv2 = dot3(duv, duv);
  if (!(d_uv2 > 0.0f && pdf_v > 0.0f)) return false;
  if (occl(ray.hp, vp)) return false;
  const float d_uv = sqrtf(fmaxf(d_uv2, 1e-30f));
  const f3 vu = duv * (1.0f / d_uv);
  sm.cos_o = fmaxf(-dot3(ray.ng, vu), 0.0f);
  sm.vu = vu;
  sm.c_v = -dot3(p.uv, vu);
  sm.den = fmaxf(pdf_v * d_uv2, 1e-30f);
  sm.d_sv = fabsf(arc_v);
  sm.path = d_uv + sm.d_sv;
  sm.d_uv = d_uv;
  sm.vp = vp;
  return true;
}

// The raw terms t[3] of one unoccluded sample in the homogeneous medium
// (pair_terms): vol-vol, then vol-surf.
template <int PHASE, bool SHORT_VRLS>
__device__ __forceinline__ void vol_vol_term(const Medium& m, const Ray& ray, const VrlPair& p,
                                             const Sample& sm, float t[3]) {
  float e[3];
  float geo = m.phase<PHASE>(sm.c_u) * m.phase<PHASE>(sm.c_v) / sm.den;
  if (SHORT_VRLS) geo = geo / fmaxf(m.pdf_failure(sm.d_sv, e), 1e-30f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * m.sig_s[ch] * m.sig_s[ch] * expf(-m.sig_t[ch] * sm.path) * geo;
}

template <int PHASE, bool SHORT_VRLS>
__device__ __forceinline__ void vol_surf_term(const Medium& m, const Ray& ray, const VrlPair& p,
                                              const Sample& sm, float t[3]) {
  float e[3];
  float geo = m.phase<PHASE>(sm.c_v) * sm.cos_o * INV_PI / sm.den;
  if (SHORT_VRLS) geo = geo / fmaxf(m.pdf_failure(sm.d_sv, e), 1e-30f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * m.sig_s[ch] * ray.alb[ch] * ray.tau[ch] * expf(-m.sig_t[ch] * sm.path) *
            geo;
}

// f cos_o of the eye hit of a material kernel: eval_smooth of its row in
// the launch's table at the hit's normal. vrl_tex.cuh overloads it for a
// textured ray's own rows (TexMats).
__device__ __forceinline__ f3 eye_eval(const Mats& mats, const Ray& ray, f3 wi_w, f3 wo_w) {
  return eval_smooth(mats, ray.mat, ray.ng, wi_w, wo_w);
}

// The vol-surf term of the material kernels: vol_surf_term with the hit's
// eye_eval(-ray_d, -vu) (f cos_o, per channel) in place of the diffuse
// albedo times cos_o / pi. MatT: Mats, or a textured ray's TexMats.
template <int PHASE, bool SHORT_VRLS, class MatT>
__device__ __forceinline__ void vol_surf_term_mat(const Medium& m, const Ray& ray,
                                                  const VrlPair& p, const Sample& sm,
                                                  const MatT& mats, float t[3]) {
  float e[3];
  const f3 fv = eye_eval(mats, ray, ray.d * -1.0f, sm.vu * -1.0f);
  const float f[3] = {fv.x, fv.y, fv.z};
  float geo = m.phase<PHASE>(sm.c_v) / sm.den;
  if (SHORT_VRLS) geo = geo / fmaxf(m.pdf_failure(sm.d_sv, e), 1e-30f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * m.sig_s[ch] * f[ch] * ray.tau[ch] * expf(-m.sig_t[ch] * sm.path) * geo;
}

// The grid medium's extra kernel arguments: the supersampled density
// (nz, ny, nx) in device memory and the U-V quadrature's step count.
struct GridArgs {
  const float* density;
  int nz, ny, nx, uv_steps;
};

// Host check of a launch's grid arguments (none for homogeneous media).
template <bool GRID>
bool grid_ok(const GridArgs& g) {
  return !GRID || (g.density != nullptr && g.nz > 0 && g.ny > 0 && g.nx > 0 && g.uv_steps > 0);
}

// Where a cumulative-OD table (NQ + 1 entries) is read at a fraction of
// its segment clipped to [0, 1] (media.heterogeneous.interp_od): the
// entries k0 and k0 + 1 (returned), with weights 1 - w and w.
__device__ __forceinline__ int interp_at(float frac, float& w) {
  const float x = fminf(fmaxf(frac, 0.0f), 1.0f) * (float)NQ;
  const float k0f = fminf(fmaxf(floorf(x), 0.0f), (float)(NQ - 1));
  w = x - k0f;
  return (int)k0f;
}

// The table (entries `stride` apart) at that fraction.
__device__ __forceinline__ float interp_od(const float* cum, int stride, float frac) {
  float w;
  const int k0 = interp_at(frac, w);
  return cum[k0 * stride] * (1.0f - w) + cum[(k0 + 1) * stride] * w;
}

// The cotangent c of a table read at `frac`, added to its two entries.
__device__ __forceinline__ void interp_od_cot(float* d_cum, int stride, float frac, float c) {
  float w;
  const int k0 = interp_at(frac, w);
  d_cum[k0 * stride] += c * (1.0f - w);
  d_cum[(k0 + 1) * stride] += c * w;
}

// The grid medium: its pack (ops/pack.py pack_medium_hetero), staged in
// shared memory by the kernel, and the supersampled density, read
// directly from device memory through the read-only path (3.4 MB at
// config 4: it stays in the 50 MB L2). The scattering coefficient at a
// point is sigma_s_color times the nearest density; the transmittance of
// a sample is exp(-sigma_t_color od) with od the eye table's and the VRL
// table's entries at the sample's fractions of their segments plus the
// steps-point midpoint quadrature of the U-V segment; the short-VRL
// pdfFailure is exp(-chan od(S -> V)), with no sampling-weight mixture.
// The values are those of the JAX package's XLA table path
// (integrate.py:248-335), not of its CP-factored Pallas kernel (no CP
// factors here; ROADMAP C9). UV is the quadrature's step count when it
// is a compile-time constant (the grid sum and its VJP at the step count
// every caller passes, UV_STEPS), or 0 for the run-time count
// grid.uv_steps (their generic instantiation, and the clustered and R
// kernels).
//
// TRI: the trilinear form (a medium of fast_tau False, whose quadratures
// the JAX package's XLA route reads trilinearly, _lookup_quad and
// sigma_s_at; ROADMAP C20): grid.density is then the density itself
// (nz, ny, nx), each lookup (density) reads its cell's 8 corners through
// the read-only path and lerps them in x, then y, then z
// (lookup_density), and the pack's index scales are n - 1. The forward
// kernels 3, 4 and 6 and the backward kernels 9 and 11 (trilinear_cot,
// TriQuad) have it, at the run-time step count (UV = 0). It stays
// bound by operations, as the nearest form: the density (442 KB at
// config 4) stays in L2, a lookup's 8 loads are four pairs of
// neighbouring floats, and its lerps add about 36 operations to the
// nearest read's (chip_smoke.py GRID_OPS "trilinear").
constexpr int UV_STEPS = 4;  // VRLConfig.uv_tau_steps

template <int UV = 0, bool TRI = false>
struct GridMedium {
  const float* m;  // the pack, GRID_MED_LEN floats in shared memory
  GridArgs grid;

  __device__ GridMedium(const float* s_med, const GridArgs& args) : m(s_med), grid(args) {}

  __device__ __forceinline__ int steps() const { return UV > 0 ? UV : grid.uv_steps; }

  // TRI: the trilinear density at p times the scale (0 outside the box;
  // media/heterogeneous.py lookup_density on the pack's box and scales)
  __device__ __forceinline__ float trilinear(f3 p) const {
    const float qx = (p.x - m[G_BOX0]) * m[G_INV_E];
    const float qy = (p.y - m[G_BOX0 + 1]) * m[G_INV_E + 1];
    const float qz = (p.z - m[G_BOX0 + 2]) * m[G_INV_E + 2];
    if (!(qx >= 0.0f && qx <= 1.0f && qy >= 0.0f && qy <= 1.0f && qz >= 0.0f && qz <= 1.0f))
      return 0.0f;
    const float gx = qx * m[G_INDEX_SCALE], gy = qy * m[G_INDEX_SCALE + 1],
                gz = qz * m[G_INDEX_SCALE + 2];
    const float x0 = fminf(fmaxf(floorf(gx), 0.0f), m[G_INDEX_SCALE] - 1.0f);
    const float y0 = fminf(fmaxf(floorf(gy), 0.0f), m[G_INDEX_SCALE + 1] - 1.0f);
    const float z0 = fminf(fmaxf(floorf(gz), 0.0f), m[G_INDEX_SCALE + 2] - 1.0f);
    const float fx = fminf(fmaxf(gx - x0, 0.0f), 1.0f);
    const float fy = fminf(fmaxf(gy - y0, 0.0f), 1.0f);
    const float fz = fminf(fmaxf(gz - z0, 0.0f), 1.0f);
    const size_t sy = (size_t)grid.nx, sz = (size_t)grid.ny * grid.nx;
    const float* d = grid.density + (size_t)z0 * sz + (size_t)y0 * sy + (size_t)x0;
    const float d000 = __ldg(d), d001 = __ldg(d + 1);
    const float d010 = __ldg(d + sy), d011 = __ldg(d + sy + 1);
    const float d100 = __ldg(d + sz), d101 = __ldg(d + sz + 1);
    const float d110 = __ldg(d + sz + sy), d111 = __ldg(d + sz + sy + 1);
    const float c00 = d000 * (1.0f - fx) + d001 * fx;
    const float c01 = d010 * (1.0f - fx) + d011 * fx;
    const float c10 = d100 * (1.0f - fx) + d101 * fx;
    const float c11 = d110 * (1.0f - fx) + d111 * fx;
    const float c0 = c00 * (1.0f - fy) + c01 * fy;
    const float c1 = c10 * (1.0f - fy) + c11 * fy;
    return (c0 * (1.0f - fz) + c1 * fz) * m[G_SCALE];
  }

  // the supersampled entry that the density at p reads, as a flat index
  // into (nz, ny, nx): the nearest one (indices rounded half to even,
  // like jnp.round in lookup_density_nn); -1 outside the box. The
  // forward's reads and the backward's scatters both go through here.
  __device__ __forceinline__ int voxel(f3 p) const {
    const float qx = (p.x - m[G_BOX0]) * m[G_INV_E];
    const float qy = (p.y - m[G_BOX0 + 1]) * m[G_INV_E + 1];
    const float qz = (p.z - m[G_BOX0 + 2]) * m[G_INV_E + 2];
    if (!(qx >= 0.0f && qx <= 1.0f && qy >= 0.0f && qy <= 1.0f && qz >= 0.0f && qz <= 1.0f))
      return -1;
    const int ix = min((int)fminf(rintf(qx * m[G_INDEX_SCALE]), m[G_INDEX_SCALE]), grid.nx - 1);
    const int iy = min((int)fminf(rintf(qy * m[G_INDEX_SCALE + 1]), m[G_INDEX_SCALE + 1]),
                       grid.ny - 1);
    const int iz = min((int)fminf(rintf(qz * m[G_INDEX_SCALE + 2]), m[G_INDEX_SCALE + 2]),
                       grid.nz - 1);
    return (iz * grid.ny + iy) * grid.nx + ix;
  }

  // the raw density entry at voxel v, 0 for -1
  __device__ __forceinline__ float raw(int v) const { return v < 0 ? 0.0f : __ldg(grid.density + v); }

  // the density read at voxel v: its entry times the scale, 0 for -1
  __device__ __forceinline__ float value(int v) const {
    return v < 0 ? 0.0f : __ldg(grid.density + v) * m[G_SCALE];
  }

  // the density at p
  __device__ __forceinline__ float density(f3 p) const {
    if constexpr (TRI)
      return trilinear(p);
    else
      return value(voxel(p));
  }

  // the voxel of step i of the midpoint quadrature of a -> a + delta
  __device__ __forceinline__ int step_voxel(f3 a, f3 delta, int i) const {
    const float t = ((float)i + 0.5f) / (float)steps();
    return voxel(a + delta * t);
  }

  // The cotangent c of a density read at voxel v: c * scale onto the
  // entry of d_density (an atomic add whose result is unused, so it
  // compiles to a reduction), and c * raw(v) returned, the read's share
  // of d scale. Nothing for a read outside the box, whose value is
  // forced to 0, or for a cotangent of exactly 0.
  __device__ __forceinline__ float scatter(float* d_density, int v, float c) const {
    if (v < 0 || c == 0.0f) return 0.0f;
    atomicAdd(d_density + v, c * m[G_SCALE]);
    return c * __ldg(grid.density + v);
  }

  // TRI: the cotangent c of the trilinear read at p (trilinear's cell
  // and weights): c * scale * each corner's lerp weight onto its entry of
  // d_density (reductions), and c times the lerped raw density returned,
  // the read's share of d scale. Nothing outside the box or for c = 0.
  __device__ __forceinline__ float trilinear_cot(float* d_density, f3 p, float c) const {
    const float qx = (p.x - m[G_BOX0]) * m[G_INV_E];
    const float qy = (p.y - m[G_BOX0 + 1]) * m[G_INV_E + 1];
    const float qz = (p.z - m[G_BOX0 + 2]) * m[G_INV_E + 2];
    if (c == 0.0f ||
        !(qx >= 0.0f && qx <= 1.0f && qy >= 0.0f && qy <= 1.0f && qz >= 0.0f && qz <= 1.0f))
      return 0.0f;
    const float gx = qx * m[G_INDEX_SCALE], gy = qy * m[G_INDEX_SCALE + 1],
                gz = qz * m[G_INDEX_SCALE + 2];
    const float x0 = fminf(fmaxf(floorf(gx), 0.0f), m[G_INDEX_SCALE] - 1.0f);
    const float y0 = fminf(fmaxf(floorf(gy), 0.0f), m[G_INDEX_SCALE + 1] - 1.0f);
    const float z0 = fminf(fmaxf(floorf(gz), 0.0f), m[G_INDEX_SCALE + 2] - 1.0f);
    const float fx = fminf(fmaxf(gx - x0, 0.0f), 1.0f);
    const float fy = fminf(fmaxf(gy - y0, 0.0f), 1.0f);
    const float fz = fminf(fmaxf(gz - z0, 0.0f), 1.0f);
    const size_t sy = (size_t)grid.nx, sz = (size_t)grid.ny * grid.nx;
    const size_t i0 = (size_t)z0 * sz + (size_t)y0 * sy + (size_t)x0;
    const size_t at[8] = {i0, i0 + 1, i0 + sy, i0 + sy + 1,
                          i0 + sz, i0 + sz + 1, i0 + sz + sy, i0 + sz + sy + 1};
    const float wx[2] = {1.0f - fx, fx}, wy[2] = {1.0f - fy, fy}, wz[2] = {1.0f - fz, fz};
    const float cs = c * m[G_SCALE];
    float raw = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = wz[k >> 2] * wy[(k >> 1) & 1] * wx[k & 1];
      atomicAdd(d_density + at[k], cs * w);
      raw += w * __ldg(grid.density + at[k]);
    }
    return c * raw;
  }

  // the short-VRL pdfFailure exp(-chan od_sv), clamped at 1e-30; *open
  // (if given) where it is not clamped, and there the term, which it
  // divides, goes as exp(chan od_sv)
  __device__ __forceinline__ float pdf_failure(float od_sv, bool* open = nullptr) const {
    const float e = expf(-m[G_CHAN] * od_sv);
    if (open) *open = e >= 1e-30f;
    return fmaxf(e, 1e-30f);
  }
};

// The reads of the U-V quadrature of one segment a -> b: each midpoint
// step's voxel and raw density. UV > 0: all read here, once, into
// registers (the steps' loads go out together), for the optical depth
// and the backward's scatters alike. UV = 0: each step recomputed where
// it is used, for the run-time step count.
template <int UV>
struct UvReads {
  int vox[UV];
  float raw[UV];

  __device__ __forceinline__ UvReads(const GridMedium<UV>& gm, f3 a, f3 b) {
    const f3 delta = b - a;
#pragma unroll
    for (int i = 0; i < UV; ++i) {
      vox[i] = gm.step_voxel(a, delta, i);
      raw[i] = gm.raw(vox[i]);
    }
  }

  // midpoint optical depth of the segment, of length dist
  __device__ __forceinline__ float od(const GridMedium<UV>& gm, float dist) const {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < UV; ++i) total += raw[i] * gm.m[G_SCALE];
    return total * dist / (float)UV;
  }
};

template <>
struct UvReads<0> {
  f3 a, delta;

  __device__ __forceinline__ UvReads(const GridMedium<0>&, f3 a_, f3 b) : a(a_), delta(b - a_) {}

  __device__ __forceinline__ float od(const GridMedium<0>& gm, float dist) const {
    float total = 0.0f;
    for (int i = 0; i < gm.grid.uv_steps; ++i) total += gm.value(gm.step_voxel(a, delta, i));
    return total * dist / (float)gm.grid.uv_steps;
  }

  // the cotangent c of od(gm, dist) onto every step's read; returns
  // their share of d scale
  __device__ __forceinline__ float cot(const GridMedium<0>& gm, float* d_density, float dist,
                                       float c) const {
    const float c_step = c * dist / (float)gm.grid.uv_steps;
    float d_scale = 0.0f;
    for (int i = 0; i < gm.grid.uv_steps; ++i)
      d_scale += gm.scatter(d_density, gm.step_voxel(a, delta, i), c_step);
    return d_scale;
  }
};

// The trilinear form's U-V quadrature of a -> b at the run-time step
// count: its optical depth (uv_od's, in step order) and the cotangent of
// that, onto each step's trilinear read (GridMedium::trilinear_cot).
struct TriQuad {
  f3 a, delta;

  __device__ __forceinline__ TriQuad(const GridMedium<0, true>&, f3 a_, f3 b)
      : a(a_), delta(b - a_) {}

  __device__ __forceinline__ f3 step(int i, int n) const {
    return a + delta * (((float)i + 0.5f) / (float)n);
  }

  __device__ __forceinline__ float od(const GridMedium<0, true>& gm, float dist) const {
    const int n = gm.steps();
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total += gm.density(step(i, n));
    return total * dist / (float)n;
  }

  // returns the steps' share of d scale
  __device__ __forceinline__ float cot(const GridMedium<0, true>& gm, float* d_density,
                                       float dist, float c) const {
    const int n = gm.steps();
    const float c_step = c * dist / (float)n;
    float d_scale = 0.0f;
    for (int i = 0; i < n; ++i) d_scale += gm.trilinear_cot(d_density, step(i, n), c_step);
    return d_scale;
  }
};

// The reads of a grid sample's U-V quadrature in the backward: UvReads
// (nearest) or TriQuad (trilinear, UV = 0).
template <int UV, bool TRI>
using QuadReads = std::conditional_t<TRI, TriQuad, UvReads<UV>>;

// The density cotangents of one trilinear sample (density_cots' for the
// trilinear form): c_a at the read at pa (U; none for a vol-surf
// sample, has_a false), c_q over the quadrature q of a segment of length
// dist, and c_b at the read at pb (V); one reduction per corner of each
// read.
__device__ __forceinline__ void density_cots_tri(const GridMedium<0, true>& gm, float* d_density,
                                                 bool has_a, f3 pa, float c_a, const TriQuad& q,
                                                 float dist, float c_q, f3 pb, float c_b,
                                                 float& d_scale) {
  d_scale += q.cot(gm, d_density, dist, c_q);
  if (has_a) d_scale += gm.trilinear_cot(d_density, pa, c_a);
  d_scale += gm.trilinear_cot(d_density, pb, c_b);
}

// The U-V quadrature's optical depth of a -> b, of length dist: the
// nearest form's reads (UvReads), or the trilinear form's densities at
// the midpoints of the run-time step count, summed in step order
// (integrate.py grid_segment_od).
template <int UV, bool TRI>
__device__ __forceinline__ float uv_od(const GridMedium<UV, TRI>& gm, f3 a, f3 b, float dist) {
  if constexpr (TRI) {
    const f3 delta = b - a;
    const int n = gm.steps();
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total += gm.density(a + delta * (((float)i + 0.5f) / (float)n));
    return total * dist / (float)n;
  } else {
    return UvReads<UV>(gm, a, b).od(gm, dist);
  }
}

// The density cotangents of one grid sample: c_a at the read of voxel
// va (U; -1 for a vol-surf sample, which has none), c_q spread over the
// quadrature's steps q of a segment of length dist, and c_b at voxel vb
// (V). Each read adds cotangent * scale to d_density (a reduction) and
// cotangent * raw, its share of d scale, to d_scale; reads outside the
// box and cotangents of exactly 0 add nothing. UV > 0: the reads in path
// order (U, the steps, V), consecutive reads of one voxel merged into
// one reduction; UV = 0: one reduction per read, as the clustered VJP
// makes them.
template <int UV>
__device__ __forceinline__ void density_cots(const GridMedium<UV>& gm, float* d_density, int va,
                                             float ra, float c_a, const UvReads<UV>& q,
                                             float dist, float c_q, int vb, float rb, float c_b,
                                             float& d_scale) {
  if constexpr (UV == 0) {
    d_scale += q.cot(gm, d_density, dist, c_q);
    d_scale += gm.scatter(d_density, va, c_a);
    d_scale += gm.scatter(d_density, vb, c_b);
  } else {
    const float c_step = c_q * dist / (float)UV;
    const float scale = gm.m[G_SCALE];
    constexpr int R = UV + 2;
    int vox[R];
    float val[R];
    auto read = [&](int k, int v, float r, float c) {
      const bool live = v >= 0 && c != 0.0f;
      vox[k] = live ? v : -1;
      val[k] = c * scale;
      if (live) d_scale += c * r;
    };
    read(0, va, ra, c_a);
#pragma unroll
    for (int i = 0; i < UV; ++i) read(i + 1, q.vox[i], q.raw[i], c_step);
    read(R - 1, vb, rb, c_b);
#pragma unroll
    for (int k = 1; k < R; ++k)
      if (vox[k] >= 0 && vox[k] == vox[k - 1]) {
        val[k] += val[k - 1];
        vox[k - 1] = -1;
      }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (vox[k] >= 0) atomicAdd(d_density + vox[k], val[k]);
  }
}

// The raw terms t[3] of one unoccluded sample in the grid medium
// (pair_terms): vol-vol, then vol-surf.
template <int PHASE, bool SHORT_VRLS, int UV, bool TRI>
__device__ __forceinline__ void vol_vol_term(const GridMedium<UV, TRI>& gm, const Ray& ray,
                                             const VrlPair& p, const Sample& sm, float t[3]) {
  const float* m = gm.m;
  const float od_sv = interp_od(p.vod, VRL_CHUNK, sm.d_sv * p.ivl);
  const float od = interp_od(ray.eod, ray.eod_stride, sm.d_eu / ray.elen) +
                   uv_od(gm, sm.up, sm.vp, sm.d_uv) + od_sv;
  const float dens_u = gm.density(sm.up), dens_v = gm.density(sm.vp);
  float geo = phase_eval<PHASE>(m[G_G], sm.c_u) * phase_eval<PHASE>(m[G_G], sm.c_v) / sm.den;
  if (SHORT_VRLS) geo = geo / gm.pdf_failure(od_sv);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * (m[G_SIG_S + ch] * dens_v) * (m[G_SIG_S + ch] * dens_u) *
            expf(-m[G_SIG_T + ch] * od) * geo;
}

template <int PHASE, bool SHORT_VRLS, int UV, bool TRI>
__device__ __forceinline__ void vol_surf_term(const GridMedium<UV, TRI>& gm, const Ray& ray,
                                              const VrlPair& p, const Sample& sm, float t[3]) {
  const float* m = gm.m;
  const float od_sv = interp_od(p.vod, VRL_CHUNK, sm.d_sv * p.ivl);
  const float od = uv_od(gm, ray.hp, sm.vp, sm.d_uv) + od_sv;
  const float dens_v = gm.density(sm.vp);
  float geo = phase_eval<PHASE>(m[G_G], sm.c_v) * sm.cos_o * INV_PI / sm.den;
  if (SHORT_VRLS) geo = geo / gm.pdf_failure(od_sv);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * (m[G_SIG_S + ch] * dens_v) * ray.alb[ch] * ray.tau[ch] *
            expf(-m[G_SIG_T + ch] * od) * geo;
}

// The vol-surf term of the material kernels in the grid medium: the grid
// vol_surf_term with the hit's eye_eval(-ray_d, -vu) (f cos_o, per
// channel) in place of the diffuse albedo times cos_o / pi.
template <int PHASE, bool SHORT_VRLS, int UV, bool TRI, class MatT>
__device__ __forceinline__ void vol_surf_term_mat(const GridMedium<UV, TRI>& gm, const Ray& ray,
                                                  const VrlPair& p, const Sample& sm,
                                                  const MatT& mats, float t[3]) {
  const float* m = gm.m;
  const f3 fv = eye_eval(mats, ray, ray.d * -1.0f, sm.vu * -1.0f);
  const float f[3] = {fv.x, fv.y, fv.z};
  const float od_sv = interp_od(p.vod, VRL_CHUNK, sm.d_sv * p.ivl);
  const float od = uv_od(gm, ray.hp, sm.vp, sm.d_uv) + od_sv;
  const float dens_v = gm.density(sm.vp);
  float geo = phase_eval<PHASE>(m[G_G], sm.c_v) / sm.den;
  if (SHORT_VRLS) geo = geo / gm.pdf_failure(od_sv);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    t[ch] = p.pw[ch] * (m[G_SIG_S + ch] * dens_v) * f[ch] * ray.tau[ch] *
            expf(-m[G_SIG_T + ch] * od) * geo;
}

// The medium of a kernel instantiation: Medium read from the pack `med`
// (homogeneous; EXT: with the pack's extension, as kernels 1, 2 and 5
// read it), or GridMedium<UV, TRI> on the pack staged at s_med.
template <bool GRID, int UV = 0, bool EXT = false, bool TRI = false>
__device__ __forceinline__ std::conditional_t<GRID, GridMedium<UV, TRI>, Medium> make_medium(
    const float* __restrict__ med, const float* s_med, const GridArgs& grid) {
  if constexpr (GRID)
    return GridMedium<UV, TRI>(s_med, grid);
  else if constexpr (EXT)
    return Medium(med, std::true_type{});
  else
    return Medium(med);
}

// The grid kernels' per-block set-up: the medium pack into s_med (before
// the block's first barrier) and the ray's eye-OD table.
template <bool GRID>
__device__ __forceinline__ void stage_medium(const float* __restrict__ med, float* s_med) {
  if constexpr (GRID)
    for (int i = threadIdx.x; i < GRID_MED_LEN; i += blockDim.x) s_med[i] = med[i];
}

template <bool GRID>
__device__ __forceinline__ void attach_eod(Ray& ray, const float* __restrict__ rays, int B, int b) {
  if constexpr (GRID) {
    ray.eod = rays + (size_t)EOD * B + b;
    ray.eod_stride = B;
  }
}

// The grid sum's and its VJP's eye-OD table: copied into the thread's
// column of s_etab (NQ + 1 rows of RAY_BLOCK floats in shared memory),
// which only this thread reads, so each sample's two reads leave device
// memory.
template <bool GRID>
__device__ __forceinline__ void stage_eod(Ray& ray, const float* __restrict__ rays, int B, int b,
                                          float* s_etab) {
  if constexpr (GRID) {
    float* col = s_etab + threadIdx.x;
    for (int k = 0; k <= NQ; ++k) col[k * RAY_BLOCK] = rays[(size_t)(EOD + k) * B + b];
    ray.eod = col;
    ray.eod_stride = RAY_BLOCK;
  }
}

// The samples of one (ray, VRL) pair, shared by every kernel: for each
// sample that is not dropped, in draw order, on_sample(family, sm) with
// family 0 for vol-vol and 1 for vol-surf. A dropped sample (occl, the
// shadow test, blocks it) contributes 0 and is not passed on.
template <class Occl, class OnSample>
__device__ __forceinline__ void pair_samples(const Ray& ray, const VrlPair& p, PairUniforms& draw,
                                             int svv, int svs, const Occl& occl,
                                             OnSample&& on_sample) {
  for (int i = 0; i < svv; ++i) {
    const float u1 = draw(2 * i), u2 = draw(2 * i + 1);
    Sample sm;
    if (!vol_vol_sample(ray, p, u1, u2, occl, sm)) continue;
    on_sample(0, sm);
  }
  for (int k = 0; k < svs && ray.alb_any; ++k) {
    const float u1 = draw(2 * svv + k);
    Sample sm;
    if (!vol_surf_sample(ray, p, u1, occl, sm)) continue;
    on_sample(1, sm);
  }
}

// The estimator of one (ray, VRL) pair, shared by the three forward
// kernels (vrl_sum.cu, vrl_sum_clustered.cu, vrl_r.cu), which differ only
// in how they reduce its terms, and by both media (Med: Medium or
// GridMedium), which differ only in the terms of a sample: for each
// sample of pair_samples, emit(family, t) with t[3] the raw per-sample
// contribution (not divided by the family's sample count). MAT (the
// material kernels, with their table `mats`, in either medium): the
// vol-surf term evaluates the hit's smooth BSDF (vol_surf_term_mat);
// MAT = false is the diffuse term, unchanged. MatT: Mats, or the
// textured forms' own view of the eye hit (vrl_tex.cuh TexMats, with its
// eye_eval).
template <int PHASE, bool SHORT_VRLS, bool MAT = false, class Med, class Occl, class Emit,
          class MatT = Mats>
__device__ __forceinline__ void pair_terms(const Ray& ray, const VrlPair& p, const Med& m,
                                           PairUniforms& draw, int svv, int svs, const Occl& occl,
                                           Emit&& emit, const MatT* mats = nullptr) {
  pair_samples(ray, p, draw, svv, svs, occl, [&](int family, const Sample& sm) {
    float t[3];
    if (family == 0)
      vol_vol_term<PHASE, SHORT_VRLS>(m, ray, p, sm, t);
    else if constexpr (MAT)
      vol_surf_term_mat<PHASE, SHORT_VRLS>(m, ray, p, sm, *mats, t);
    else
      vol_surf_term<PHASE, SHORT_VRLS>(m, ray, p, sm, t);
    emit(family, t);
  });
}

// The backward's accumulators of one thread (one eye ray), for the
// output cotangent gb of its ray: the medium's sums over its pairs
// (sigma_t, sigma_s, g; d_chan, the short-VRL pdfFailure's rate: grid
// chan, or with the homogeneous pack's extension the strategy's rate
// rho; grid: the density scale), its ray's
// d_tau, and the current pair's d_power; for the grid medium also the
// cotangent columns of its eye-OD table (summed over the block's VRLs)
// and of the current VRL's OD table (entries RAY_BLOCK apart, in shared
// memory), and the density cotangent grid in device memory.
struct Cot {
  float gb[3];
  float d_st[3], d_ss[3], d_g, d_chan, d_scale;
  float d_tau[3], d_pw[3];
  float* d_eod;
  float* d_vod;
  float* d_density;
};

// The cotangents of one sample's terms (vol_vol_term, vol_surf_term) at
// the weight inv (1 / the family's sample count), one overload per
// medium. Each is a product of the term's other factors, never the term
// divided by the value it differentiates, so a zero channel of power,
// sigma_s, tau or density still gets its derivative (ROADMAP C7). All
// take <PHASE, SHORT_VRLS, EXT, MAT>: EXT, the homogeneous pack's
// extension (kernels 8 and 10: the mixture, PHASE 2, whose g gets no
// cotangent, and the strategy's rate, which takes the pdfFailure's
// derivative in place of sigma_t); MAT, the vol-surf term's eval_smooth
// f (per channel, f cos_o) in place of albedo cos_o / pi, as
// vol_surf_term_mat, with the material table `mats`.
template <int PHASE, bool SHORT_VRLS, bool EXT = false, bool MAT = false>
__device__ __forceinline__ void vol_vol_cot(const Medium& m, const Ray& ray, const VrlPair& p,
                                            const Sample& sm, float inv, Cot& c) {
  float e[3];
  const float ph_u = m.phase<PHASE>(sm.c_u);
  const float ph_v = m.phase<PHASE>(sm.c_v);
  float geo = ph_u * ph_v / sm.den;  // the term per unit power and sigma_s^2 tau
  float geo_g = (phase_dg<PHASE>(m.g, sm.c_u) * ph_v + ph_u * phase_dg<PHASE>(m.g, sm.c_v)) / sm.den;
  float pf = 1.0f;
  if (SHORT_VRLS) {
    pf = m.pdf_failure(sm.d_sv, e);
    geo = geo / fmaxf(pf, 1e-30f);
    geo_g = geo_g / fmaxf(pf, 1e-30f);
  }
  float gt_all = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ss = m.sig_s[ch], pw = p.pw[ch];
    const float w = c.gb[ch] * expf(-m.sig_t[ch] * sm.path) * inv;
    const float gt = w * pw * ss * ss * geo;  // gbar * term
    c.d_pw[ch] += w * ss * ss * geo;
    c.d_ss[ch] += w * pw * 2.0f * ss * geo;
    c.d_st[ch] -= sm.path * gt;
    c.d_g += w * pw * ss * ss * geo_g;
    gt_all += gt;
  }
  if (SHORT_VRLS && pf >= 1e-30f) {  // the term goes as 1 / pf
    if constexpr (EXT) {
      if (m.rho > 0.0f) {  // pf = msw exp(-rho x) + 1 - msw: d rho
        c.d_chan += gt_all * m.msw * sm.d_sv * e[0] / pf;
        return;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c.d_st[ch] += gt_all * m.msw * sm.d_sv * e[ch] / (3.0f * pf);
  }
}

// channel ch of a material form's f cos_o (eval_smooth's f3)
__device__ __forceinline__ float surface(f3 fv, int ch) {
  return ch == 0 ? fv.x : (ch == 1 ? fv.y : fv.z);
}

template <int PHASE, bool SHORT_VRLS, bool EXT = false, bool MAT = false>
__device__ __forceinline__ void vol_surf_cot(const Medium& m, const Ray& ray, const VrlPair& p,
                                             const Sample& sm, float inv, Cot& c,
                                             const Mats* mats = nullptr) {
  float e[3];
  // MAT: the hit's f cos_o in place of alb (surface), and no cos_o / pi
  const f3 fv = MAT ? eval_smooth(*mats, ray.mat, ray.ng, ray.d * -1.0f, sm.vu * -1.0f) : f3{};
  float geo = MAT ? m.phase<PHASE>(sm.c_v) / sm.den
                  : m.phase<PHASE>(sm.c_v) * sm.cos_o * INV_PI / sm.den;
  float geo_g = MAT ? phase_dg<PHASE>(m.g, sm.c_v) / sm.den
                    : phase_dg<PHASE>(m.g, sm.c_v) * sm.cos_o * INV_PI / sm.den;
  float pf = 1.0f;
  if (SHORT_VRLS) {
    pf = m.pdf_failure(sm.d_sv, e);
    geo = geo / fmaxf(pf, 1e-30f);
    geo_g = geo_g / fmaxf(pf, 1e-30f);
  }
  float gt_all = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ss = m.sig_s[ch], pw = p.pw[ch], tau = ray.tau[ch];
    const float alb = MAT ? surface(fv, ch) : ray.alb[ch];
    const float w = c.gb[ch] * expf(-m.sig_t[ch] * sm.path) * inv;
    const float gt = w * pw * ss * alb * tau * geo;  // gbar * term
    c.d_pw[ch] += w * ss * alb * tau * geo;
    c.d_ss[ch] += w * pw * alb * tau * geo;
    c.d_tau[ch] += w * pw * ss * alb * geo;
    c.d_st[ch] -= sm.path * gt;
    c.d_g += w * pw * ss * alb * tau * geo_g;
    gt_all += gt;
  }
  if (SHORT_VRLS && pf >= 1e-30f) {
    if constexpr (EXT) {
      if (m.rho > 0.0f) {
        c.d_chan += gt_all * m.msw * sm.d_sv * e[0] / pf;
        return;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c.d_st[ch] += gt_all * m.msw * sm.d_sv * e[ch] / (3.0f * pf);
  }
}

// Grid vol-vol: the term is pw (sigma_s dens_v) (sigma_s dens_u)
// exp(-sigma_t od) geo, od = the eye table at d_eu / |E|, the U-V
// quadrature and the VRL table at d_sv / |VRL|. The od cotangent goes
// onto the two table entries each read touches and onto every
// quadrature step's voxel; the density cotangents onto the voxels of U
// and V; each voxel read also adds its share of d scale. TRI: the reads
// and their cotangents are the trilinear ones (TriQuad,
// density_cots_tri), each onto its 8 corners.
template <int PHASE, bool SHORT_VRLS, bool EXT = false, bool MAT = false, int UV, bool TRI>
__device__ __forceinline__ void vol_vol_cot(const GridMedium<UV, TRI>& gm, const Ray& ray,
                                            const VrlPair& p, const Sample& sm, float inv,
                                            Cot& c) {
  static_assert(!EXT, "the grid medium has no pack extension");
  const float* m = gm.m;
  const float f_sv = sm.d_sv * p.ivl, f_eu = sm.d_eu / ray.elen;
  const float od_sv = interp_od(p.vod, VRL_CHUNK, f_sv);
  const QuadReads<UV, TRI> q(gm, sm.up, sm.vp);
  const float od = interp_od(ray.eod, ray.eod_stride, f_eu) + q.od(gm, sm.d_uv) + od_sv;
  int vox_u = -1, vox_v = -1;
  float raw_u = 0.0f, raw_v = 0.0f, dens_u, dens_v;
  if constexpr (TRI) {
    dens_u = gm.density(sm.up);
    dens_v = gm.density(sm.vp);
  } else {
    vox_u = gm.voxel(sm.up);
    vox_v = gm.voxel(sm.vp);
    raw_u = gm.raw(vox_u);
    raw_v = gm.raw(vox_v);
    dens_u = raw_u * m[G_SCALE];
    dens_v = raw_v * m[G_SCALE];
  }
  const float ph_u = phase_eval<PHASE>(m[G_G], sm.c_u);
  const float ph_v = phase_eval<PHASE>(m[G_G], sm.c_v);
  float geo = ph_u * ph_v / sm.den;
  float geo_g =
      (phase_dg<PHASE>(m[G_G], sm.c_u) * ph_v + ph_u * phase_dg<PHASE>(m[G_G], sm.c_v)) / sm.den;
  bool open = false;  // the term goes as exp(chan od_sv): slopes od_sv, chan
  if (SHORT_VRLS) {
    const float pf = gm.pdf_failure(od_sv, &open);
    geo = geo / pf;
    geo_g = geo_g / pf;
  }
  float gt_all = 0.0f, c_od = 0.0f, c_du = 0.0f, c_dv = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ss = m[G_SIG_S + ch], pw = p.pw[ch];
    const float w = c.gb[ch] * expf(-m[G_SIG_T + ch] * od) * inv;
    const float a = w * geo;
    const float su = ss * dens_u, sv = ss * dens_v;
    const float gt = a * pw * sv * su;  // gbar * term
    c.d_pw[ch] += a * sv * su;
    c.d_ss[ch] += a * pw * 2.0f * ss * dens_v * dens_u;
    c.d_st[ch] -= od * gt;
    c.d_g += w * geo_g * pw * sv * su;
    c_du += a * pw * sv * ss;
    c_dv += a * pw * su * ss;
    c_od -= m[G_SIG_T + ch] * gt;
    gt_all += gt;
  }
  float c_sv = c_od;
  if (open) {
    c.d_chan += gt_all * od_sv;
    c_sv += gt_all * m[G_CHAN];
  }
  interp_od_cot(c.d_eod, RAY_BLOCK, f_eu, c_od);
  interp_od_cot(c.d_vod, RAY_BLOCK, f_sv, c_sv);
  if constexpr (TRI)
    density_cots_tri(gm, c.d_density, true, sm.up, c_du, q, sm.d_uv, c_od, sm.vp, c_dv,
                     c.d_scale);
  else
    density_cots(gm, c.d_density, vox_u, raw_u, c_du, q, sm.d_uv, c_od, vox_v, raw_v, c_dv,
                 c.d_scale);
}

// Grid vol-surf: pw (sigma_s dens_v) alb tau exp(-sigma_t od) geo, od =
// the quadrature from the hit point to V and the VRL table at d_sv
// (MAT: f cos_o, per channel, in place of alb cos_o / pi).
template <int PHASE, bool SHORT_VRLS, bool EXT = false, bool MAT = false, int UV, bool TRI>
__device__ __forceinline__ void vol_surf_cot(const GridMedium<UV, TRI>& gm, const Ray& ray,
                                             const VrlPair& p, const Sample& sm, float inv,
                                             Cot& c, const Mats* mats = nullptr) {
  static_assert(!EXT, "the grid medium has no pack extension");
  const float* m = gm.m;
  const float f_sv = sm.d_sv * p.ivl;
  const float od_sv = interp_od(p.vod, VRL_CHUNK, f_sv);
  const QuadReads<UV, TRI> q(gm, ray.hp, sm.vp);
  const float od = q.od(gm, sm.d_uv) + od_sv;
  int vox_v = -1;
  float raw_v = 0.0f, dens_v;
  if constexpr (TRI) {
    dens_v = gm.density(sm.vp);
  } else {
    vox_v = gm.voxel(sm.vp);
    raw_v = gm.raw(vox_v);
    dens_v = raw_v * m[G_SCALE];
  }
  const f3 fv = MAT ? eval_smooth(*mats, ray.mat, ray.ng, ray.d * -1.0f, sm.vu * -1.0f) : f3{};
  float geo = MAT ? phase_eval<PHASE>(m[G_G], sm.c_v) / sm.den
                  : phase_eval<PHASE>(m[G_G], sm.c_v) * sm.cos_o * INV_PI / sm.den;
  float geo_g = MAT ? phase_dg<PHASE>(m[G_G], sm.c_v) / sm.den
                    : phase_dg<PHASE>(m[G_G], sm.c_v) * sm.cos_o * INV_PI / sm.den;
  bool open = false;
  if (SHORT_VRLS) {
    const float pf = gm.pdf_failure(od_sv, &open);
    geo = geo / pf;
    geo_g = geo_g / pf;
  }
  float gt_all = 0.0f, c_od = 0.0f, c_dv = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ss = m[G_SIG_S + ch], pw = p.pw[ch], tau = ray.tau[ch];
    const float alb = MAT ? surface(fv, ch) : ray.alb[ch];
    const float w = c.gb[ch] * expf(-m[G_SIG_T + ch] * od) * inv;
    const float a = w * geo;
    const float sv = ss * dens_v;
    const float gt = a * pw * sv * alb * tau;  // gbar * term
    c.d_pw[ch] += a * sv * alb * tau;
    c.d_ss[ch] += a * pw * dens_v * alb * tau;
    c.d_tau[ch] += a * pw * sv * alb;
    c.d_st[ch] -= od * gt;
    c.d_g += w * geo_g * pw * sv * alb * tau;
    c_dv += a * pw * ss * alb * tau;
    c_od -= m[G_SIG_T + ch] * gt;
    gt_all += gt;
  }
  float c_sv = c_od;
  if (open) {
    c.d_chan += gt_all * od_sv;
    c_sv += gt_all * m[G_CHAN];
  }
  interp_od_cot(c.d_vod, RAY_BLOCK, f_sv, c_sv);
  if constexpr (TRI)
    density_cots_tri(gm, c.d_density, false, sm.vp, 0.0f, q, sm.d_uv, c_od, sm.vp, c_dv,
                     c.d_scale);
  else
    density_cots(gm, c.d_density, -1, 0.0f, 0.0f, q, sm.d_uv, c_od, vox_v, raw_v, c_dv,
                 c.d_scale);
}

// Picks one of a kernel's instantiations {HG, Rayleigh} x {short, long
// VRLs}, and with MIX (kernels 1, 2 and 5 in their homogeneous forms)
// also the mixture, PHASE 2, for phase kind PHASE_MIXTURE: calls
// launch(phase, short_vrls) with two std::integral_constant values, whose
// ::value the launching lambda passes as the kernel's template
// arguments. Returns cudaErrorInvalidValue, launching nothing, for a
// phase kind that has no instantiation; else cudaSuccess.
template <bool MIX = false, class Launch>
int dispatch(int phase_kind, int short_vrls, Launch&& launch) {
  auto go = [&](auto phase) {
    if (short_vrls)
      launch(phase, std::true_type{});
    else
      launch(phase, std::false_type{});
  };
  if (phase_kind == 0)
    go(std::integral_constant<int, 0>{});
  else if (phase_kind == 1)
    go(std::integral_constant<int, 1>{});
  else if (MIX && phase_kind == PHASE_MIXTURE) {
    if constexpr (MIX) go(std::integral_constant<int, 2>{});
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// dispatch for the grid sum and its VJP, whose grid instantiations also
// take the U-V quadrature's step count as a template argument: launch(phase,
// short_vrls, uv) with uv an std::integral_constant of UV_STEPS where a
// grid launch has that many steps, else of 0 (the run-time count; every
// homogeneous launch). MIX as dispatch's, for the homogeneous forms only.
template <bool GRID, bool MIX = false, class Launch>
int dispatch(int phase_kind, int short_vrls, int uv_steps, Launch&& launch) {
  return dispatch<MIX && !GRID>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    if constexpr (GRID) {
      if (uv_steps == UV_STEPS) {
        launch(phase, short_, std::integral_constant<int, UV_STEPS>{});
        return;
      }
    }
    launch(phase, short_, std::integral_constant<int, 0>{});
  });
}

// dispatch for the forward grid kernels 3, 4 and 6, which also have the
// trilinear form: launch(phase, short_vrls, uv, tri) with tri an
// std::integral_constant<bool>. trilinear (grid launches only): the
// trilinear form at the run-time step count (uv 0); else tri false and
// uv as dispatch<GRID, MIX>'s.
template <bool GRID, bool MIX = false, class Launch>
int dispatch_read(int phase_kind, int short_vrls, int uv_steps, int trilinear, Launch&& launch) {
  if constexpr (GRID) {
    if (trilinear)
      return dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
        launch(phase, short_, std::integral_constant<int, 0>{}, std::true_type{});
      });
  }
  return dispatch<GRID, MIX>(phase_kind, short_vrls, uv_steps,
                             [&](auto phase, auto short_, auto uv) {
                               launch(phase, short_, uv, std::false_type{});
                             });
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (a launch
// above the default cap of 48 KB needs leave); returns a cudaError_t.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Whether a launch takes `mode`: MODE_SUM, MODE_CHECK with its counts
// where the kernel has a checking instantiation (CHECK), or
// MODE_NO_REJECT where it has a sweep without the pre-reject (NO_REJECT).
template <bool CHECK, bool NO_REJECT = false>
bool mode_ok(int mode, const unsigned long long* counts) {
  return mode == MODE_SUM || (NO_REJECT && mode == MODE_NO_REJECT) ||
         (CHECK && mode == MODE_CHECK && counts != nullptr);
}

// The front of a launch whose kernel sweeps a plane pack (PLANES): the
// pack of the T triangles `tris` made on `stream` into `planes` ((T, 4
// PLANE_F4) floats of scratch; may be null for T = 0), which then
// stands for `tris`. Without PLANES it does nothing. Returns a
// cudaError_t.
template <bool PLANES>
int pack_planes(const float*& tris, int T, float* planes, void* stream) {
  if (!PLANES || T == 0) return (int)cudaSuccess;
  if (planes == nullptr) return (int)cudaErrorInvalidValue;
  const int err = alvrl_plane_pack(tris, T, planes, stream);
  if (err == 0) tris = planes;
  return err;
}

// The blocks of RAY_BLOCK threads resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the instantiation
// that a launch of the grid sum or its VJP with these arguments takes
// (grid 0 or 1; T triangles; the step count picks the grid
// instantiation), into *blocks; returns a cudaError_t. kernel_of(grid,
// phase, short_vrls, uv) names the instantiation and smem_of(grid, T)
// its dynamic shared memory in bytes (grid etc. as std::integral_constant).
template <class KernelOf, class SmemOf>
int occupancy(int grid, int T, int uv_steps, int phase_kind, int short_vrls, int* blocks,
              KernelOf&& kernel_of, SmemOf&& smem_of) {
  cudaError_t err = cudaSuccess;
  auto query = [&](auto grid_) {
    const size_t smem = smem_of(grid_, T);
    const int d = dispatch<decltype(grid_)::value>(
        phase_kind, short_vrls, uv_steps, [&](auto phase, auto short_, auto uv) {
          auto kernel = kernel_of(grid_, phase, short_, uv);
          err = allow_smem(kernel, smem);
          if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, RAY_BLOCK, smem);
        });
    if (d != 0) err = (cudaError_t)d;
  };
  if (grid)
    query(std::true_type{});
  else
    query(std::false_type{});
  return (int)err;
}

// out[i] = sum over parts p of part[p, i] (part: (n_parts, len)), in
// part order, accumulated in Acc (float, or double for long sums that
// cancel: the grid VJP's per-VRL sums over 2,048 ray blocks, ROADMAP
// C12): deterministic, one thread per output.
template <class Acc>
__global__ void reduce_parts(const float* __restrict__ part, int n_parts, int len,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  Acc s = 0;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * len + i];
  out[i] = (float)s;
}

// --- the backward kernels' reductions (vrl_sum_bwd.cu, vrl_sum_clustered_bwd.cu)

constexpr int N_PAR = 8;  // homogeneous d_par rows
constexpr int N_WARPS = RAY_BLOCK / 32;
// The backwards' launch bound: BWD_MIN_BLOCKS resident blocks an SM (at
// most 128 registers a thread). Without it the grid instantiations sit
// at the 128-register edge and cross it with small changes of code (3
// blocks: kernels 9 and 11 6-9 % slower); five blocks (96 registers)
// spill 100-250 B and measured up to 15 % slower (PERF.md).
constexpr int BWD_MIN_BLOCKS = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The layout of one backward instantiation: the rows of its per-ray and
// per-VRL (or per-column) outputs (3, and NQ + 1 OD-table rows in a grid
// medium), its sums (sigma_t (3), sigma_s (3), g; grid: chan, scale;
// EXT, the homogeneous pack's extension: rho, in d_chan) and d_par's
// length (EXT: up to and with the pack's rate entry, MED_RHO).
template <bool GRID, bool EXT = false>
struct Layout {
  static constexpr int N_OD = GRID ? NQ + 1 : 0;
  static constexpr int ROWS = 3 + N_OD;
  static constexpr int N_SUMS = GRID ? 9 : (EXT ? 8 : 7);
  static constexpr int N_PAR_OUT = GRID ? GRID_MED_LEN : (EXT ? MED_RHO + 1 : N_PAR);

  // d_par's entry t: the index of its sum, or -1 for a constant 0
  __host__ __device__ static constexpr int sum_of(int t) {
    return (EXT && t == MED_RHO) ? 7
           : t < 8 ? (t < N_SUMS && !(EXT && t == 7) ? t : -1)
                   : (GRID && t == G_SCALE ? 8 : -1);
  }

  // dynamic shared memory, in floats, with tri_floats floats of
  // triangles: the triangles, the VRL piece, the grid medium, the
  // per-warp column sums, the per-warp d_par sums, and each thread's
  // d_eod and d_vod columns and staged eye-OD table (stage_eod)
  static constexpr size_t smem_floats(size_t tri_floats) {
    return tri_floats + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
           (GRID ? GRID_MED_LEN : 0) + N_WARPS * ROWS * VRL_CHUNK + N_WARPS * N_SUMS +
           3 * N_OD * RAY_BLOCK;
  }
};

// The cotangents of one (ray, VRL) pair's samples, added into c: the
// forward's samples (pair_samples, the same draws), each through its
// family's cotangent (weights inv_vv, inv_vs); EXT and MAT (with the
// material table `mats`) as the cotangents take them.
template <int PHASE, bool SHORT_VRLS, bool EXT = false, bool MAT = false, class Med, class Occl>
__device__ __forceinline__ void pair_cots(const Ray& ray, const VrlPair& p, const Med& m,
                                          PairUniforms& draw, int svv, int svs, const Occl& occl,
                                          float inv_vv, float inv_vs, Cot& c,
                                          const Mats* mats = nullptr) {
  pair_samples(ray, p, draw, svv, svs, occl, [&](int family, const Sample& sm) {
    if (family == 0)
      vol_vol_cot<PHASE, SHORT_VRLS, EXT>(m, ray, p, sm, inv_vv, c);
    else
      vol_surf_cot<PHASE, SHORT_VRLS, EXT, MAT>(m, ray, p, sm, inv_vs, c, mats);
  });
}

// Clear the per-VRL cotangents of a thread before its next pair: d_pw
// and, in a grid medium, its d_vod column.
template <bool GRID>
__device__ __forceinline__ void clear_pair_cots(Cot& c) {
  for (int ch = 0; ch < 3; ++ch) c.d_pw[ch] = 0.0f;
#pragma unroll
  for (int k = 0; k < Layout<GRID>::N_OD; ++k) c.d_vod[k * RAY_BLOCK] = 0.0f;
}

// After a VRL (or table column) cc: each warp's sum of its threads'
// d_pw (and d_vod column) by a fixed butterfly, into s_out (N_WARPS,
// ROWS, VRL_CHUNK) at [warp, r, cc]. Every thread of the block calls it.
// (A reduce-scatter of the grid's 20 rows in 21 shuffles, in place of
// 100, measured 9-12 % slower in kernels 9 and 11: its 20 live values
// cost the kernels registers and spills; ROADMAP B.)
template <bool GRID>
__device__ __forceinline__ void warp_column_sums(const Cot& c, float* s_out, int cc) {
  using L = Layout<GRID>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < L::ROWS; ++r) {
    const float v = warp_sum(r < 3 ? c.d_pw[r] : c.d_vod[(r - 3) * RAY_BLOCK]);
    if (lane == 0) s_out[(warp * L::ROWS + r) * VRL_CHUNK + cc] = v;
  }
}

// The block's sum of row r, column cc of s_out: the warps in order.
template <bool GRID>
__device__ __forceinline__ float block_column_sum(const float* s_out, int r, int cc) {
  float v = 0.0f;
  for (int w = 0; w < N_WARPS; ++w) v += s_out[(w * Layout<GRID>::ROWS + r) * VRL_CHUNK + cc];
  return v;
}

// A block's d_par sums (the cotangents' sums of its threads) into its
// row of par_part (n_blocks, N_PAR_OUT): each warp by shuffles, then the
// warps in order (s_par: (N_WARPS, N_SUMS) of shared memory). Every
// thread of the block calls it; it ends on a barrier's far side.
template <bool GRID, bool EXT = false>
__device__ __forceinline__ void block_par_sums(const Cot& c, float* s_par, float* par_part,
                                               size_t block) {
  using L = Layout<GRID, EXT>;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const float sums[9] = {c.d_st[0], c.d_st[1], c.d_st[2], c.d_ss[0], c.d_ss[1],
                         c.d_ss[2], c.d_g,     c.d_chan,  c.d_scale};
#pragma unroll
  for (int i = 0; i < L::N_SUMS; ++i) {
    const float v = warp_sum(sums[i]);
    if (lane == 0) s_par[warp * L::N_SUMS + i] = v;
  }
  __syncthreads();
  if (t < L::N_PAR_OUT) {
    float v = 0.0f;
    const int s = L::sum_of(t);
    if (s >= 0)
      for (int w = 0; w < N_WARPS; ++w) v += s_par[w * L::N_SUMS + s];
    par_part[block * L::N_PAR_OUT + t] = v;
  }
}

// out[i] = sum over parts p of part[p, i] for many parts and few outputs:
// one block per output; thread t adds parts t, t + TREE, ... in order,
// then the block adds its threads by a fixed tree. Deterministic.
constexpr int TREE = 256;

__global__ void __launch_bounds__(TREE)
    reduce_parts_tree(const float* __restrict__ part, int n_parts, int len,
                      float* __restrict__ out) {
  __shared__ float s[TREE];
  const int i = blockIdx.x;
  float v = 0.0f;
  for (int p = threadIdx.x; p < n_parts; p += TREE) v += part[(size_t)p * len + i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = TREE / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = s[0];
}

}  // namespace
