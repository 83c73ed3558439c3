// VJP of the VRL x eye-ray sum (vrl_sum.cu) for homogeneous media,
// hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas_bwd.py:vrl_sum_pallas_bwd (its body
// `_bwd_kernel` with hetero=False, clustered=False). Given the output
// cotangent gbar (3, B), it replays the forward's samples (the same
// Philox counters (b, n, call) or injected uniforms, in the same draw
// order, through the same functions of vrl_common.cuh) and accumulates
//   d_power (3, N)  per VRL, summed over the rays;
//   d_par   (8,)    sigma_t 0:3, sigma_s 3:6, g 6, and 0 at 7;
//   d_tau   (3, B)  per ray, summed over the VRLs.
// Plain PyTorch twin: ops/vrl_sum_bwd.py:vrl_sum_bwd_reference.
//
// Every cotangent is a product of the other factors of the term, never
// the term divided by the value it differentiates: d tau of vol-surf is
// gbar * pw * sigma_s * alb * tau_seg * geo / svs, not gbar * term / tau.
// The reference's quotients are 0 wherever that channel of power,
// sigma_s or tau is 0, though the term is linear in it.
//
// What bounds it: as the forward, fp32 ALU and SFU work per pair-sample
// (the replay costs the forward's samples; the cotangents add a few
// dozen flops and one phase derivative per sample). The design follows
// the forward's grid (RAY_BLOCK rays x VRL_CHUNK VRLs per block) and
// reduces with no atomics, in a fixed order, so a repeat is
// bit-identical:
//   * d_tau: each thread sums its ray's cotangent over the block's VRLs
//     into (n_chunks, 3, B) partials, added in chunk order;
//   * d_power: after each VRL, the block's rays are summed by warp
//     shuffles (a fixed butterfly) and the warps in order, into
//     (n_ray_blocks, 3, N) partials, added in ray-block order;
//   * d_par: each block sums its threads the same way into
//     (n_blocks, 8) partials, added by a fixed tree.
// Threads past the last ray stay in the loop (with no samples) so that
// every lane takes part in the shuffles.

#include "vrl_common.cuh"

namespace {

constexpr int N_PAR = 8;   // d_par rows
constexpr int N_SUMS = 7;  // of which accumulated: sigma_t (3), sigma_s (3), g
constexpr int N_WARPS = RAY_BLOCK / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// d phase / d g; c = dot(wi, wo). Rayleigh has no g.
template <int PHASE>
__device__ __forceinline__ float phase_dg(float g, float c) {
  if (PHASE == 1) return 0.0f;
  const float raw = 1.0f + g * g + 2.0f * g * c;
  const float temp = fmaxf(raw, 1e-12f);
  const float dtemp = raw >= 1e-12f ? 2.0f * (g + c) : 0.0f;  // 0 where clamped
  return INV_FOURPI * (-2.0f * g - 1.5f * (1.0f - g * g) * dtemp / temp) / (temp * sqrtf(temp));
}

template <int PHASE, bool SHORT_VRLS>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_bwd_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float* __restrict__ tris, int T,
                       const float* __restrict__ med, const float* __restrict__ uniforms,
                       uint32_t seed, int svv, int svs, const float* __restrict__ gbar,
                       float* __restrict__ tau_part, float* __restrict__ pw_part,
                       float* __restrict__ par_part) {
  extern __shared__ float smem[];
  float* s_tri = smem;                              // (T, TRI_COLS)
  float* s_vrl = s_tri + T * TRI_COLS;              // (VRL_ROWS, VRL_CHUNK)
  float* s_dpw = s_vrl + VRL_ROWS * VRL_CHUNK;      // (N_WARPS, 3, VRL_CHUNK)
  float* s_par = s_dpw + N_WARPS * 3 * VRL_CHUNK;   // (N_WARPS, N_SUMS)
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  const int nc = stage_block(tris, T, vrls, N, n0, s_tri, s_vrl);
  for (int i = threadIdx.x; i < N_WARPS * 3 * VRL_CHUNK; i += blockDim.x) s_dpw[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = b < B;
  Ray ray{};
  float gb[3] = {0.0f, 0.0f, 0.0f};
  if (in_range) {
    ray = load_ray(rays, B, b);
    for (int ch = 0; ch < 3; ++ch) gb[ch] = gbar[(size_t)ch * B + b];
  }
  const Medium m(med);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float d_st[3] = {0.0f, 0.0f, 0.0f}, d_ss[3] = {0.0f, 0.0f, 0.0f}, d_g = 0.0f;
  float d_tau[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;  // the same for the whole block
    float d_pw[3] = {0.0f, 0.0f, 0.0f};
    if (ray.ok) {
      const int n = n0 + c;
      const VrlPair p = pair_setup(ray, s_vrl, c);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
      float e[3];
      for (int i = 0; i < svv; ++i) {
        const float u1 = draw(2 * i), u2 = draw(2 * i + 1);
        Sample sm;
        if (!vol_vol_sample(ray, p, u1, u2, s_tri, T, sm)) continue;
        const float ph_u = phase_eval<PHASE>(m.g, sm.c_u);
        const float ph_v = phase_eval<PHASE>(m.g, sm.c_v);
        float geo = ph_u * ph_v / sm.den;  // the term per unit power and sigma_s^2 tau
        float geo_g =
            (phase_dg<PHASE>(m.g, sm.c_u) * ph_v + ph_u * phase_dg<PHASE>(m.g, sm.c_v)) / sm.den;
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
          const float w = gb[ch] * expf(-m.sig_t[ch] * sm.path) * inv_vv;
          const float gt = w * pw * ss * ss * geo;  // gbar * term
          d_pw[ch] += w * ss * ss * geo;
          d_ss[ch] += w * pw * 2.0f * ss * geo;
          d_st[ch] -= sm.path * gt;
          d_g += w * pw * ss * ss * geo_g;
          gt_all += gt;
        }
        if (SHORT_VRLS && pf >= 1e-30f) {  // the term goes as 1 / pf
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            d_st[ch] += gt_all * m.msw * sm.d_sv * e[ch] / (3.0f * pf);
        }
      }
      for (int k = 0; k < svs && ray.alb_any; ++k) {
        const float u1 = draw(2 * svv + k);
        Sample sm;
        if (!vol_surf_sample(ray, p, u1, s_tri, T, sm)) continue;
        float geo = phase_eval<PHASE>(m.g, sm.c_v) * sm.cos_o * INV_PI / sm.den;
        float geo_g = phase_dg<PHASE>(m.g, sm.c_v) * sm.cos_o * INV_PI / sm.den;
        float pf = 1.0f;
        if (SHORT_VRLS) {
          pf = m.pdf_failure(sm.d_sv, e);
          geo = geo / fmaxf(pf, 1e-30f);
          geo_g = geo_g / fmaxf(pf, 1e-30f);
        }
        float gt_all = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float ss = m.sig_s[ch], pw = p.pw[ch], alb = ray.alb[ch], tau = ray.tau[ch];
          const float w = gb[ch] * expf(-m.sig_t[ch] * sm.path) * inv_vs;
          const float gt = w * pw * ss * alb * tau * geo;  // gbar * term
          d_pw[ch] += w * ss * alb * tau * geo;
          d_ss[ch] += w * pw * alb * tau * geo;
          d_tau[ch] += w * pw * ss * alb * geo;
          d_st[ch] -= sm.path * gt;
          d_g += w * pw * ss * alb * tau * geo_g;
          gt_all += gt;
        }
        if (SHORT_VRLS && pf >= 1e-30f) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            d_st[ch] += gt_all * m.msw * sm.d_sv * e[ch] / (3.0f * pf);
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = warp_sum(d_pw[ch]);
      if (lane == 0) s_dpw[(warp * 3 + ch) * VRL_CHUNK + c] = v;
    }
  }

  if (in_range) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) tau_part[((size_t)chunk * 3 + ch) * B + b] = d_tau[ch];
  }
  const float sums[N_SUMS] = {d_st[0], d_st[1], d_st[2], d_ss[0], d_ss[1], d_ss[2], d_g};
#pragma unroll
  for (int i = 0; i < N_SUMS; ++i) {
    const float v = warp_sum(sums[i]);
    if (lane == 0) s_par[warp * N_SUMS + i] = v;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < 3 * VRL_CHUNK) {
    const int ch = t / VRL_CHUNK, c = t % VRL_CHUNK;
    if (c < nc) {
      float v = 0.0f;
      for (int w = 0; w < N_WARPS; ++w) v += s_dpw[(w * 3 + ch) * VRL_CHUNK + c];
      pw_part[((size_t)blockIdx.x * 3 + ch) * N + n0 + c] = v;
    }
  }
  if (t < N_PAR) {
    float v = 0.0f;
    if (t < N_SUMS)
      for (int w = 0; w < N_WARPS; ++w) v += s_par[w * N_SUMS + t];
    par_part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * N_PAR + t] = v;
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

extern "C" {

int alvrl_ray_block() { return RAY_BLOCK; }

// Launches the backward and its three ordered reductions on `stream`;
// returns a cudaError_t (0 = launched). Scratch: tau_part (n_chunks, 3,
// B), pw_part (n_ray_blocks, 3, N), par_part (n_ray_blocks * n_chunks,
// 8). Out: d_power (3, N), d_par (8,), d_tau (3, B). `uniforms` may be
// null (the Philox stream of `seed`, as the forward's).
int alvrl_vrl_sum_bwd(const float* rays, int B, const float* vrls, int N, const float* tris,
                      int T, const float* med, const float* uniforms, unsigned int seed, int svv,
                      int svs, int short_vrls, int phase_kind, const float* gbar, float* tau_part,
                      int n_chunks, float* pw_part, int n_ray_blocks, float* par_part,
                      float* d_power, float* d_par, float* d_tau, void* stream) {
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1) || n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK ||
      n_chunks > MAX_GRID_Y || n_ray_blocks != (B + RAY_BLOCK - 1) / RAY_BLOCK)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_ray_blocks, n_chunks);
  const size_t smem = (size_t)(T * TRI_COLS + VRL_ROWS * VRL_CHUNK + N_WARPS * 3 * VRL_CHUNK +
                               N_WARPS * N_SUMS) *
                      sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    vrl_sum_bwd_kernel<decltype(phase)::value, decltype(short_)::value>
        <<<grid, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs,
                                        gbar, tau_part, pw_part, par_part);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts<<<(3 * B + 255) / 256, 256, 0, st>>>(tau_part, n_chunks, 3 * B, d_tau);
  reduce_parts<<<(3 * N + 255) / 256, 256, 0, st>>>(pw_part, n_ray_blocks, 3 * N, d_power);
  reduce_parts_tree<<<N_PAR, TREE, 0, st>>>(par_part, n_ray_blocks * n_chunks, N_PAR, d_par);
  return (int)cudaGetLastError();
}

}  // extern "C"
