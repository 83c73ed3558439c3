// Transfer matrix R, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_r_pallas (its body `_kernel`
// with r_mode=True, hetero=False; entry point alvrl_vrl_r) and, for grid
// media, vrl_r_pallas_hetero (hetero=True; alvrl_vrl_r_hetero, the grid
// estimator and staging of vrl_sum.cu). For each representative eye ray p and
// VRL n it returns the luminance (Rec. 709 weights 0.212671, 0.715160,
// 0.072169) of the pair's per-sample contributions reduced per sample
// family f (vol-vol, vol-surf) to a mean and a variance of the mean,
//   mean[p, n] = sum_f mu_f,   mu_f = sum_i x_i / n_f,
//   var[p, n]  = sum_f max(sum_i x_i^2 - n_f mu_f^2, 0) / (n_f - 1) / n_f
// (the second term only for n_f > 1), out (2, P, N) float32, not
// normalised by the particle count. A dropped sample counts as 0. Plain
// PyTorch twins: ops/vrl_r.py:vrl_r_reference and vrl_r_hetero_reference.
// The estimator is the one of vrl_sum.cu, from vrl_common.cuh
// (pair_terms, templated on the medium).
//
// What bounds it on the H100: fp32 ALU and SFU throughput, as vrl_sum
// (per pair-sample about 150 float32 operations and 20 special-function
// operations, and 59 operations per triangle of its shadow sweep, as
// chip_smoke.py's OPS counts them; a grid sample about 100 and 4 more,
// GRID_OPS), on an input under 1 MB (at config 2: 271 rays x 512 VRLs x
// 6 draws; config 4 adds its 3.4 MB density grid, which stays in L2).
// The output, 2 P N floats (1.1 MB at config 2, 8.3 MB at config 4's
// 2,032 rays), is small beside that work. The design follows
// vrl_sum.cu's grid (RAY_BLOCK rays x VRL_CHUNK VRLs per block, triangles
// and the chunk in shared memory) so that a few hundred rays still fill
// the card: every pair is one thread's loop step, and each pair's two
// outputs are written once, with no reduction across threads. Threads
// write with a stride of N floats between neighbouring rays; at 1.1 MB
// the writes are not what bounds the kernel.
//
// Random numbers: Philox4x32-10 with key (seed, 0) and counter (p, n,
// call, 0), the draw order of vrl_sum.cu, so that sum_n mean[p, n] is the
// luminance of vrl_sum's out[:, p] on the same rays and seed (up to f32
// summation order). `uniforms`, when given, is read instead, as (P, N,
// 2 * svv + svs) float32.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_common.cuh"

namespace {

constexpr float LUM_R = 0.212671f, LUM_G = 0.715160f, LUM_B = 0.072169f;  // Rec. 709

template <int PHASE, bool SHORT_VRLS, bool GRID>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_r_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                 const float* __restrict__ tris, int T, const float* __restrict__ med,
                 GridArgs grid, const float* __restrict__ uniforms, uint32_t seed, int svv,
                 int svs, float* __restrict__ out) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float smem[];
  float* s_tri = smem;                        // (T, TRI_COLS)
  float* s_vrl = smem + T * TRI_COLS;         // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;  // grid: (GRID_MED_LEN,)
  const int n0 = blockIdx.y * VRL_CHUNK;
  const int nc = stage_block(tris, T, vrls, N, n0, s_tri, s_vrl, V_ROWS);
  stage_medium<GRID>(med, s_med);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Ray ray = load_ray(rays, B, b);
  attach_eod<GRID>(ray, rays, B, b);
  const auto m = make_medium<GRID>(med, s_med, grid);
  const int n_draws = 2 * svv + svs;
  const int n_samples[2] = {svv, svs};

  for (int c = 0; c < nc; ++c) {
    const int n = n0 + c;
    float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
    if (ray.ok && s_vrl[VVALID * VRL_CHUNK + c] > 0.5f) {
      const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_terms<PHASE, SHORT_VRLS>(ray, p, m, draw, svv, svs, FlatTris{s_tri, T},
                                    [&](int family, const float* t) {
                                      const float lum = LUM_R * t[0] + LUM_G * t[1] +
                                                        LUM_B * t[2];
                                      sum[family] += lum;
                                      sq[family] += lum * lum;
                                    });
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
}

// Launches the R kernel on `stream`; returns a cudaError_t (0 =
// launched).
template <bool GRID>
int launch_r(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
             const float* med, GridArgs grid, const float* uniforms, unsigned int seed, int svv,
             int svs, int short_vrls, int phase_kind, float* out, void* stream) {
  const int n_chunks = (N + VRL_CHUNK - 1) / VRL_CHUNK;
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1) || n_chunks > MAX_GRID_Y || !grid_ok<GRID>(grid))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = (size_t)(T * TRI_COLS + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
                               (GRID ? GRID_MED_LEN : 0)) *
                      sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    vrl_r_kernel<decltype(phase)::value, decltype(short_)::value, GRID>
        <<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, uniforms, seed,
                                          svv, svs, out);
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The homogeneous R. `out` is (2, B, N); `uniforms` may be null (Philox
// stream from `seed`).
int alvrl_vrl_r(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                const float* med, const float* uniforms, unsigned int seed, int svv, int svs,
                int short_vrls, int phase_kind, float* out, void* stream) {
  return launch_r<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, uniforms, seed, svv, svs,
                         short_vrls, phase_kind, out, stream);
}

// The grid-medium R: the grid packs (ops/pack.py), the supersampled
// density (nz, ny, nx) and the U-V quadrature's step count; the rest as
// alvrl_vrl_r.
int alvrl_vrl_r_hetero(const float* rays, int B, const float* vrls, int N, const float* tris,
                       int T, const float* med, const float* density, int nz, int ny, int nx,
                       int uv_steps, const float* uniforms, unsigned int seed, int svv, int svs,
                       int short_vrls, int phase_kind, float* out, void* stream) {
  return launch_r<true>(rays, B, vrls, N, tris, T, med, GridArgs{density, nz, ny, nx, uv_steps},
                        uniforms, seed, svv, svs, short_vrls, phase_kind, out, stream);
}

}  // extern "C"
