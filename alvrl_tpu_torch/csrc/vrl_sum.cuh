// The body of the grid VRL sum (kernel 3), shared by vrl_sum.cu, whose
// header gives the design, and vrl_sum_grid_tex.cu, which instantiates
// its textured form.
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include "vrl_tex.cuh"

namespace {

// The sum of a block (RAY_BLOCK rays x the chunk of VRLs blockIdx.y),
// the body of vrl_sum.cu's grid kernels. MAT: the material form, its M
// table rows staged after the eye-OD tables (grid) and attached to the
// ray (the grid ray pack's GRID_MATID row); MAT = false ignores
// mat_table, M and rt. TEX (with MAT): the textured form
// (vrl_sum_grid_tex.cu), each thread's three rows (vrl_tex.cuh
// stage_tex_rows, the ray's TexMats in its EyeTable) staged after the
// table.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, bool TRI = false, bool MAT = false,
          bool TEX = false>
__device__ __forceinline__ void sum_block(const float* __restrict__ rays, int B,
                                          const float* __restrict__ vrls, int N,
                                          const float* __restrict__ tris, int T,
                                          const float* __restrict__ med, GridArgs grid,
                                          const float* __restrict__ uniforms, uint32_t seed,
                                          int svv, int svs, float* __restrict__ partial,
                                          const float* __restrict__ mat_table = nullptr,
                                          int M = 0, const float* __restrict__ rt = nullptr) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float smem[];
  float* s_tri = smem;                    // (T, TRI_COLS)
  float* s_vrl = smem + T * TRI_COLS;     // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;  // grid: (GRID_MED_LEN,)
  float* s_etab = s_med + (GRID ? GRID_MED_LEN : 0);  // grid: (NQ + 1, RAY_BLOCK)
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  const int nc = stage_block(tris, T, vrls, N, n0, s_tri, s_vrl, V_ROWS);
  stage_medium<GRID>(med, s_med);
  EyeTable<TEX> mats{};
  if constexpr (MAT)  // (M, MAT_COLS)
    mats = stage_mats(mat_table, M, rt, s_etab + (GRID ? (NQ + 1) * RAY_BLOCK : 0));
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Ray ray = load_ray(rays, B, b);
  if constexpr (MAT) attach_mat<GRID>(ray, rays, B, b, mats);
  if constexpr (TEX)
    mats.tm = stage_tex_rows<GRID>(mats, ray.mat, rays, B, b,
                                   tex_rows(s_etab + (GRID ? (NQ + 1) * RAY_BLOCK : 0), M));
  stage_eod<GRID>(ray, rays, B, b, s_etab);
  const auto m = make_medium<GRID, UV, false, TRI>(med, s_med, grid);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray.ok && c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
    const int n = n0 + c;
    const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS, MAT>(
        ray, p, m, draw, svv, svs, FlatTris{s_tri, T},
        [&](int family, const float* t) {
          const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
        },
        &mats);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
}

}  // namespace
