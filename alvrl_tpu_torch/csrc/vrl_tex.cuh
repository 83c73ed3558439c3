// Device code shared by the textured forms (TEX) of kernels 1, 2 and 5
// (vrl_sum_tex.cu, vrl_sum_clustered_tex.cu, vrl_r_tex.cu): the material
// forms' kernels (vrl_sum.cu's vrl_sum_plane_kernel, vrl_sum_clustered.cu's
// vrl_sum_clustered_warps_kernel, vrl_r.cu's vrl_r_kernel) on the textured
// ray pack (ops/pack.py TEX_RAY_ROWS); and by those of the grid kernels 3,
// 4 and 6 (on the grid textured ray pack, GRID_TEX_RAY_ROWS) and of kernel
// 7, which are their material forms' bodies (vrl_sum.cuh sum_block,
// vrl_sum_clustered.cuh, vrl_r.cuh vrl_r_kernel, vrl_bvh.cuh bvh_block)
// with TEX set: the ray's rows staged behind `if constexpr (TEX)`
// (stage_tex_rows, stage_tex_row) and its TexMats in place of the table
// (EyeTable, TexTable). A textured table's eye hit carries its shading
// normal and the albedos of its material's leaf and of its nested and
// nested2 leaves (TEX_NS, TEX_ALB), resolved once a ray on the host
// (bsdf/api.py shading, at the hit's point and UV). Each thread stages its
// ray's three material rows with those albedos in shared memory after the
// launch's table (stage_tex), and the vol-surf term evaluates them with
// the material forms' eval_smooth (a NORMALMAP as a MASK of opacity 1 over
// its nested leaf at the shading normal) or, for the HK slab, hk_eval
// (eval_smooth_tex, vrl_common.cuh vol_surf_term_mat through eye_eval).
// The C entries alvrl_vrl_sum, alvrl_vrl_sum_clustered, alvrl_vrl_r,
// alvrl_vrl_sum_hetero, alvrl_vrl_sum_hetero_clustered, alvrl_vrl_r_hetero
// and alvrl_vrl_sum_bvh launch them with their `tex` argument set.
//
// Each form is compiled in a source of its own, so the material forms'
// sources hold the machine code they held, which every earlier form
// keeps (scripts/sass_compare.py). Kernels 1, 2 and 5's textured bodies
// are copies of their material forms' (a textured branch in those bodies
// moved the material forms' code; PERF.md). Plain versions:
// the material forms' (ops/vrl_sum.py _pair_terms on the textured pack).
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include "vrl_common.cuh"

namespace {

// the textured ray pack (ops/pack.py TEX_RAY_ROWS): after MATID, the
// hit's shading normal (TEX_NS) and the albedos of its material's leaf,
// nested and nested2 leaves (TEX_ALB, three rows each)
constexpr int TEX_NS = MATID + 1, TEX_ALB = TEX_NS + 3;
constexpr int K_NORMALMAP = 13, K_HK = 14;  // scene/scene.py's kinds
// a thread's three material rows (TexMats), RAY_BLOCK of them a block
constexpr int TEX_ROW_FLOATS = 3 * MAT_COLS;
constexpr int TEX_SMEM_FLOATS = RAY_BLOCK * TEX_ROW_FLOATS;

// layered.py hk_eval: f |cos_o| of the HK slab's glossy reflection and
// transmission, its row's albedo sigma_s, albedo2 sigma_a, exponent the
// thickness and alpha the HG phase's g; wi, wo local
__device__ f3 hk_eval(const float* r, f3 wi, f3 wo) {
  const float th = r[MT_EXP], g = r[MT_ALPHA];
  const float ci = wi.z, co = wo.z;
  const float aci = fmaxf(fabsf(ci), 1e-6f), aco = fmaxf(fabsf(co), 1e-6f);
  const float phase = phase_eval<0>(g, dot3(wi, wo));
  const float dp = ci * co;
  const bool close = fabsf(ci + co) < 1e-4f;
  const float denom = fabsf(aci - aco) < 1e-6f ? 1e-6f : aci - aco;
  float f[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ss = r[MT_ALB + ch], sa = r[MT_ALB2 + ch];
    const float tau = (ss + sa) * th, st = ss + sa;
    const float albedo = st > 0.0f ? ss / fmaxf(st, 1e-30f) : 0.0f;
    float v = 0.0f;
    if (dp > 0.0f) {
      v = albedo * phase * (ci / (ci + co)) * (1.0f - expf(-(1.0f / aci + 1.0f / aco) * tau));
    } else if (dp < 0.0f) {
      v = close ? albedo * phase * (tau / aco) * expf(-tau / aco)
                : albedo * phase * (aci / denom) * (expf(-tau / aci) - expf(-tau / aco));
    }
    f[ch] = fmaxf(v, 0.0f);
  }
  return {f[0], f[1], f[2]};
}

// The eye hit of a textured ray: a table of three rows, the material's
// and its nested and nested2 materials' with the hit's albedos in their
// MT_ALB columns and the nested ids 1 and 2 (the rough-transmittance
// table, which only the material's own row reads, offset to its), a
// NORMALMAP row made a MASK of opacity 1 over its nested leaf; and the
// hit's shading normal.
struct TexMats {
  Mats mats;
  f3 ns;
};

// Ray b's TexMats, its rows staged in the thread's s_rows (shared memory;
// the launch's table `mats` staged).
__device__ __forceinline__ TexMats stage_tex(const Mats& mats, int mat,
                                             const float* __restrict__ rays, int B, int b,
                                             float* s_rows) {
  auto row3 = [&](int r) {
    return f3{rays[(size_t)r * B + b], rays[(size_t)(r + 1) * B + b],
              rays[(size_t)(r + 2) * B + b]};
  };
  const float* r = mats.row(mat);
  const int ids[3] = {mat, mats.clamp_id(r[MT_NESTED]), mats.clamp_id(r[MT_NESTED2])};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* src = mats.row(ids[k]);
    float* dst = s_rows + k * MAT_COLS;
    for (int c = 0; c < MAT_COLS; ++c) dst[c] = src[c];
    const f3 alb = row3(TEX_ALB + 3 * k);
    dst[MT_ALB] = alb.x;
    dst[MT_ALB + 1] = alb.y;
    dst[MT_ALB + 2] = alb.z;
  }
  s_rows[MT_NESTED] = 1.0f;
  s_rows[MT_NESTED2] = 2.0f;
  if ((int)r[MT_KIND] == K_NORMALMAP) {
    s_rows[MT_KIND] = (float)K_MASK;
    s_rows[MT_OPAC] = 1.0f;
  }
  return TexMats{Mats{s_rows, mats.rt + (size_t)mat * (RT_COS * RT_ALPHA), 3}, row3(TEX_NS)};
}

// f cos_o of a textured ray's hit (bsdf/api.py eval_smooth with its
// Shading): eval_smooth of its rows at the shading normal, or for the HK
// slab hk_eval in that normal's frame (eval_smooth's).
__device__ __forceinline__ f3 eval_smooth_tex(const TexMats& tm, f3 wi_w, f3 wo_w) {
  const float* r = tm.mats.row(0);
  if ((int)r[MT_KIND] != K_HK) return eval_smooth(tm.mats, 0, tm.ns, wi_w, wo_w);
  const f3 ng = tm.ns;
  const float sign = ng.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + ng.z);
  const float b = ng.x * ng.y * a;
  const f3 s = {1.0f + sign * ng.x * ng.x * a, sign * b, -sign * ng.x};
  const f3 t = {b, sign + ng.y * ng.y * a, -ng.y};
  return hk_eval(r, {dot3(wi_w, s), dot3(wi_w, t), dot3(wi_w, ng)},
                 {dot3(wo_w, s), dot3(wo_w, t), dot3(wo_w, ng)});
}

// f cos_o of a textured ray's eye hit: vrl_common.cuh's eye_eval on its
// TexMats, which the material forms' vol_surf_term_mat take in place of
// the table.
__device__ __forceinline__ f3 eye_eval(const TexMats& tm, const Ray&, f3 wi_w, f3 wo_w) {
  return eval_smooth_tex(tm, wi_w, wo_w);
}

// The thread's three textured rows, after the launch's M material rows.
__device__ __forceinline__ float* tex_rows(float* s_mat, int M) {
  return s_mat + M * MAT_COLS + threadIdx.x * TEX_ROW_FLOATS;
}

// The launches' common checks: a table of M rows and a summing or
// checking mode (no timing form).
bool tex_ok(const float* mat_table, int M, const float* rt, int mode,
            const unsigned long long* counts) {
  return M > 0 && mats_ok(mat_table, M, rt) && mode_ok<true>(mode, counts);
}

// The instantiation of a form for (phase, short VRLs, mode), by
// dispatch's phase and short-VRL values.
template <template <int, bool, int> class Pick, class Phase, class Short>
auto pick_tex(Phase, Short, int mode) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  return mode == MODE_CHECK ? Pick<P, S, MODE_CHECK>::kernel() : Pick<P, S, MODE_SUM>::kernel();
}

// --- the textured forms of kernels 3, 4, 6 and 7. Their rows are staged
// by the functions below, not by stage_tex, which the forms of kernels
// 1, 2 and 5 keep as it is (their machine code).

// the grid textured ray pack (ops/pack.py GRID_TEX_RAY_ROWS): the textured
// pack's rows after GRID_MATID
constexpr int GRID_TEX_NS = GRID_MATID + 1, GRID_TEX_ALB = GRID_TEX_NS + 3;

// Row k of ray b's three textured rows, as stage_tex writes it, at dst
// (k 0: the material's, with the nested ids 1 and 2 and a NORMALMAP made a
// MASK of opacity 1; 1, 2: its nested and nested2 materials'), each with
// the ray's albedos; GRID: the grid textured pack's rows.
template <bool GRID>
__device__ __forceinline__ void stage_tex_row(const Mats& mats, int mat,
                                              const float* __restrict__ rays, int B, int b, int k,
                                              float* dst) {
  constexpr int ALB0 = GRID ? GRID_TEX_ALB : TEX_ALB;
  const float* r = mats.row(mat);
  const int id = k == 0 ? mat : mats.clamp_id(r[k == 1 ? MT_NESTED : MT_NESTED2]);
  const float* src = mats.row(id);
  for (int c = 0; c < MAT_COLS; ++c) dst[c] = src[c];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) dst[MT_ALB + ch] = rays[(size_t)(ALB0 + 3 * k + ch) * B + b];
  if (k == 0) {
    dst[MT_NESTED] = 1.0f;
    dst[MT_NESTED2] = 2.0f;
    if ((int)r[MT_KIND] == K_NORMALMAP) {
      dst[MT_KIND] = (float)K_MASK;
      dst[MT_OPAC] = 1.0f;
    }
  }
}

// Ray b's TexMats on its three rows staged at s_rows (stage_tex_row).
template <bool GRID>
__device__ __forceinline__ TexMats tex_view(const Mats& mats, int mat,
                                            const float* __restrict__ rays, int B, int b,
                                            const float* s_rows) {
  constexpr int NS = GRID ? GRID_TEX_NS : TEX_NS;
  return TexMats{Mats{s_rows, mats.rt + (size_t)mat * (RT_COS * RT_ALPHA), 3},
                 f3{rays[(size_t)NS * B + b], rays[(size_t)(NS + 1) * B + b],
                    rays[(size_t)(NS + 2) * B + b]}};
}

// stage_tex for the forms of kernels 3, 4 and 7 (a thread's own rows) on
// either pack.
template <bool GRID>
__device__ __forceinline__ TexMats stage_tex_rows(const Mats& mats, int mat,
                                                  const float* __restrict__ rays, int B, int b,
                                                  float* s_rows) {
#pragma unroll 1
  for (int k = 0; k < 3; ++k) stage_tex_row<GRID>(mats, mat, rays, B, b, k, s_rows + k * MAT_COLS);
  return tex_view<GRID>(mats, mat, rays, B, b, s_rows);
}

// The table of a material form's body (its `mats`): the launch's Mats,
// or with TEX (TexTable) the launch's Mats and the ray's TexMats beside
// them, which its eye term reads (eye_eval). The body declares an
// EyeTable<TEX>, stages the table into it as before, adds the ray's rows
// behind `if constexpr (TEX)`, and hands the eye term `&mats`, so the
// material form's code stays as it was.
struct TexTable : Mats {
  TexMats tm;  // the ray's rows (stage_tex_rows)

  __device__ __forceinline__ TexTable& operator=(const Mats& m) {
    Mats::operator=(m);
    return *this;
  }
};
template <bool TEX>
using EyeTable = std::conditional_t<TEX, TexTable, Mats>;

__device__ __forceinline__ f3 eye_eval(const TexTable& t, const Ray& ray, f3 wi_w, f3 wo_w) {
  return eye_eval(t.tm, ray, wi_w, wo_w);
}

}  // namespace
