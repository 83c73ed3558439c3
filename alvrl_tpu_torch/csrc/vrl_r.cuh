// The R kernel's tiles, its pair (r_pair) and the kernel itself
// (vrl_r_kernel; kernels 5 and 6), shared by vrl_r.cu, whose header gives
// the design, and vrl_r_grid_tex.cu, which instantiates kernel 6's
// textured form.
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include "vrl_tex.cuh"

namespace {

constexpr float LUM_R = 0.212671f, LUM_G = 0.715160f, LUM_B = 0.072169f;  // Rec. 709

// the tiles, R_RAYS (grid) or H_RAYS (homogeneous) rays x VRL_CHUNK
// VRLs a block, the lanes of a warp over the VRLs (module comment)
constexpr int R_RAYS = 16, H_RAYS = 4;
static_assert((R_RAYS * VRL_CHUNK) % RAY_BLOCK == 0, "a tile of whole rounds");
static_assert(H_RAYS % N_WARPS == 0 && VRL_CHUNK == 32, "whole warps, a lane a VRL");

template <bool GRID>
__host__ __device__ constexpr int r_tile_rays() {
  return GRID ? R_RAYS : H_RAYS;
}

// The textured form's rows of tile ray r, after the M material rows:
// (R_RAYS, TEX_ROW_FLOATS) floats a block.
__device__ __forceinline__ float* r_tex_rows(float* s_mat, int M, int r) {
  return s_mat + M * MAT_COLS + r * TEX_ROW_FLOATS;
}

// The pair (ray b, VRL n = column c of the staged chunk): R's two
// numbers, written to out[:, b, n].
template <int PHASE, bool SHORT_VRLS, bool GRID, bool MAT, class Med, class Occl,
          class MatT = Mats>
__device__ __forceinline__ void r_pair(const Ray& ray, int b, int B, int n, int N, int c,
                                       const float* s_vrl, const Med& m, const Occl& occl,
                                       const float* __restrict__ uniforms, uint32_t seed,
                                       int svv, int svs, float* __restrict__ out,
                                       const MatT* mats) {
  const int n_samples[2] = {svv, svs};
  float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
  if (ray.ok && s_vrl[VVALID * VRL_CHUNK + c] > 0.5f) {
    const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * (2 * svv + svs) : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS, MAT>(
        ray, p, m, draw, svv, svs, occl,
        [&](int family, const float* t) {
          const float lum = LUM_R * t[0] + LUM_G * t[1] + LUM_B * t[2];
          sum[family] += lum;
          sq[family] += lum * lum;
        },
        mats);
  }
  float mean = 0.0f, var = 0.0f;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int k = n_samples[f];
    if (k == 0) continue;
    const float mu = sum[f] / (float)k;
    mean += mu;
    if (k > 1) var += fmaxf(sq[f] - (float)k * mu * mu, 0.0f) / (float)(k - 1) / (float)k;
  }
  out[(size_t)b * N + n] = mean;
  out[((size_t)B + b) * N + n] = var;
}

// tris: the triangles' plane pack, as sweep_floats<true>. MAT: the
// material instantiation (vrl_sum.cu's vrl_sum_plane_kernel), its M
// material rows staged after the VRL chunk (grid: after the eye-OD
// tables), each ray's material id read from its pack's MATID (grid:
// GRID_MATID) row. TEX (grid, with MAT): the textured form
// (vrl_r_grid_tex.cu); the 32 lanes of a ray share its three rows, so the
// block stages them once a ray of the tile after the table (R_RAYS x
// TEX_ROW_FLOATS floats; vrl_tex.cuh stage_tex_row), and each pair reads
// the ray's TexMats on them.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, int MODE, bool MAT, bool TRI = false,
          bool TEX = false>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_r_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                 const float* __restrict__ tris, int T, const float* __restrict__ med,
                 GridArgs grid, const float* __restrict__ mat_table, int M,
                 const float* __restrict__ rt, const float* __restrict__ uniforms, uint32_t seed,
                 int svv, int svs, float* __restrict__ out,
                 unsigned long long* __restrict__ counts) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);     // sweep_floats<true>(T)
  float* s_vrl = s_tri + sweep_floats<true>(T);       // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;          // grid: (GRID_MED_LEN,)
  float* s_etab = s_med + (GRID ? GRID_MED_LEN : 0);  // grid: (R_RAYS, NQ + 1)
  float* s_mat = s_etab + (GRID ? (NQ + 1) * R_RAYS : 0);  // MAT: (M, MAT_COLS)
  const int b0 = blockIdx.x * r_tile_rays<GRID>(), n0 = blockIdx.y * VRL_CHUNK;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri, &cnt);
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl, V_ROWS);
  stage_medium<GRID>(med, s_med);
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, s_mat);
  if constexpr (GRID)  // each ray's eye-OD table, a row of NQ + 1 floats
    for (int i = threadIdx.x; i < R_RAYS * (NQ + 1); i += blockDim.x) {
      const int r = i % R_RAYS, k = i / R_RAYS;
      s_etab[r * (NQ + 1) + k] = b0 + r < B ? rays[(size_t)(EOD + k) * B + b0 + r] : 0.0f;
    }
  __syncthreads();
  if constexpr (TEX) {  // each tile ray's three textured rows: a thread a row
    for (int i = threadIdx.x; i < R_RAYS * 3; i += blockDim.x) {
      const int r = i / 3, b = b0 + r;
      if (b < B)
        stage_tex_row<true>(mats, mats.clamp_id(rays[(size_t)GRID_MATID * B + b]), rays, B, b,
                            i % 3, r_tex_rows(s_mat, M, r) + (i % 3) * MAT_COLS);
    }
    __syncthreads();
  }

  // homogeneous: extended; TRI, the trilinear form of a grid medium of
  // fast_tau False (at UV 0)
  const auto m = make_medium<GRID, UV, !GRID, TRI>(med, s_med, grid);
  if constexpr (GRID) {
    // pair i of the tile: ray i / VRL_CHUNK, column i % VRL_CHUNK; a
    // thread takes every RAY_BLOCK-th
    for (int i = threadIdx.x; i < R_RAYS * VRL_CHUNK; i += RAY_BLOCK) {
      const int r = i / VRL_CHUNK, c = i % VRL_CHUNK;
      if (b0 + r >= B || c >= nc) continue;
      Ray ray = load_ray(rays, B, b0 + r);
      if constexpr (MAT) attach_mat<true>(ray, rays, B, b0 + r, mats);
      ray.eod = s_etab + r * (NQ + 1);
      ray.eod_stride = 1;
      if constexpr (TEX) {
        const TexMats tm =
            tex_view<true>(mats, ray.mat, rays, B, b0 + r, r_tex_rows(s_mat, M, r));
        r_pair<PHASE, SHORT_VRLS, GRID, MAT>(ray, b0 + r, B, n0 + c, N, c, s_vrl, m, occl,
                                             uniforms, seed, svv, svs, out, &tm);
      } else {
        r_pair<PHASE, SHORT_VRLS, GRID, MAT>(ray, b0 + r, B, n0 + c, N, c, s_vrl, m, occl,
                                             uniforms, seed, svv, svs, out,
                                             MAT ? &mats : nullptr);
      }
    }
  } else {
    // ray r of the tile to warp r % N_WARPS, column c to lane c: the
    // grid loop's pairs, H_RAYS / N_WARPS a thread
    const int c = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < H_RAYS; r += N_WARPS) {
      const int b = b0 + r;
      if (b >= B || c >= nc) break;
      Ray ray = load_ray(rays, B, b);
      if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
      r_pair<PHASE, SHORT_VRLS, GRID, MAT>(ray, b, B, n0 + c, N, c, s_vrl, m, occl, uniforms,
                                           seed, svv, svs, out, &mats);
    }
  }
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

}  // namespace
