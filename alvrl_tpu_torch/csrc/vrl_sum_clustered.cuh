// Kernel 4, the grid clustered VRL sum, shared by vrl_sum_clustered.cu,
// whose header gives the design, and vrl_sum_clustered_grid_tex.cu, which
// instantiates its textured form.
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include "vrl_tex.cuh"

namespace {

// Kernel 4, instantiated for GRID = true (UV steps, or 0 for the run-time
// count; MODE_SUM or MODE_CHECK; TRI, the trilinear form of a medium of
// fast_tau False, at UV 0): tile blockIdx.x, RAY_BLOCK rays of one row, a
// thread a ray; tris: the triangles' plane pack. MAT: the material form
// (glossy and layered surfaces in a grid medium: the eye hit's smooth
// BSDF, vrl_common.cuh eval_smooth; UV 0), its M table rows (the last
// three arguments) staged after the piece's ids and attached to each ray
// (the grid ray pack's GRID_MATID row); MAT = false ignores mat_table, M
// and rt. TEX (with MAT): the textured form
// (vrl_sum_clustered_grid_tex.cu), each thread's three rows (vrl_tex.cuh
// stage_tex_rows, the ray's TexMats in its EyeTable) staged after the
// table.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, int MODE, bool TRI = false,
          bool MAT = false, bool TEX = false>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_clustered_kernel(const float* __restrict__ rays, int B,
                             const float* __restrict__ vrls, int N,
                             const float* __restrict__ tris, int T,
                             const float* __restrict__ med, GridArgs grid,
                             const int* __restrict__ tile_rays,
                             const int* __restrict__ tile_row,
                             const int* __restrict__ table_ids,
                             const float* __restrict__ table_w, int C,
                             const float* __restrict__ uniforms, uint32_t seed, int svv,
                             int svs, float* __restrict__ out,
                             unsigned long long* __restrict__ counts,
                             const float* __restrict__ mat_table, int M,
                             const float* __restrict__ rt) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);     // sweep_floats<GRID>(T)
  float* s_vrl = s_tri + sweep_floats<GRID>(T);       // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;          // grid: (GRID_MED_LEN,)
  float* s_etab = s_med + (GRID ? GRID_MED_LEN : 0);  // grid: (NQ + 1, RAY_BLOCK)
  // (VRL_CHUNK,) ids of the staged table piece
  int* s_id = reinterpret_cast<int*>(s_etab + (GRID ? (NQ + 1) * RAY_BLOCK : 0));
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<GRID, MODE>(tris, T, s_tri, &cnt);
  stage_medium<GRID>(med, s_med);
  EyeTable<TEX> mats{};
  if constexpr (MAT) {
    mats = stage_mats(mat_table, M, rt, reinterpret_cast<float*>(s_id + VRL_CHUNK));
    __syncthreads();  // attach_mat reads the rows
  }

  const int b = tile_rays[(size_t)blockIdx.x * RAY_BLOCK + threadIdx.x];
  const int* ids = table_ids + (size_t)tile_row[blockIdx.x] * C;
  const float* ws = table_w + (size_t)tile_row[blockIdx.x] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    if constexpr (MAT) attach_mat<GRID>(ray, rays, B, b, mats);
    if constexpr (TEX)
      mats.tm = stage_tex_rows<GRID>(mats, ray.mat, rays, B, b,
                                     tex_rows(reinterpret_cast<float*>(s_id + VRL_CHUNK), M));
    stage_eod<GRID>(ray, rays, B, b, s_etab);  // this thread's column only
  }
  const auto m = make_medium<GRID, UV, false, TRI>(med, s_med, grid);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < C; c0 += VRL_CHUNK) {
    __syncthreads();  // the previous piece is consumed (and the triangles staged)
    const int nc = stage_table_piece(vrls, N, V_ROWS, ids, ws, C, c0, s_vrl, s_id);
    __syncthreads();
    for (int c = 0; ray.ok && c < nc; ++c) {
      if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
      const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * C + c0 + c) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)s_id[c], seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_terms<PHASE, SHORT_VRLS, MAT>(
          ray, p, m, draw, svv, svs, occl,
          [&](int family, const float* t) {
            const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
          },
          &mats);
    }
  }
  if (b >= 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[(size_t)ch * B + b] = acc[ch];
  }
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

}  // namespace
