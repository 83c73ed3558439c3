// The textured form of kernel 5, the homogeneous transfer matrix R
// (vrl_r.cu's material form on the textured ray pack), hand-written for
// Hopper (sm_90a); see vrl_tex.cuh.

#include "vrl_tex.cuh"

namespace {

// vrl_r.cu's homogeneous tile: H_RAYS rays x VRL_CHUNK VRLs, lanes over
// VRLs
constexpr int H_RAYS = 4;
static_assert(H_RAYS % N_WARPS == 0 && VRL_CHUNK == 32, "whole warps, a lane a VRL");
constexpr float LUM_R = 0.212671f, LUM_G = 0.715160f, LUM_B = 0.072169f;  // Rec. 709

// Kernel 5's textured form (vrl_r.cu's vrl_r_kernel<PHASE, SHORT_VRLS,
// false, 0, MODE, true>: tiles of H_RAYS rays x VRL_CHUNK VRLs, ray r to
// warp r % N_WARPS, column c to lane c); each pair's R numbers as
// vrl_r.cu's r_pair.
template <int PHASE, bool SHORT_VRLS, int MODE>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_r_tex_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                     const float* __restrict__ tris, int T, const float* __restrict__ med,
                     const float* __restrict__ mat_table, int M, const float* __restrict__ rt,
                     const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                     float* __restrict__ out, unsigned long long* __restrict__ counts) {
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);  // sweep_floats<true>(T)
  float* s_vrl = s_tri + sweep_floats<true>(T);    // (VRL_ROWS, VRL_CHUNK)
  float* s_mat = s_vrl + VRL_ROWS * VRL_CHUNK;
  const int b0 = blockIdx.x * H_RAYS, n0 = blockIdx.y * VRL_CHUNK;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri, &cnt);
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl, VRL_ROWS);
  const Mats mats = stage_mats(mat_table, M, rt, s_mat);
  __syncthreads();

  const Medium m(med, std::true_type{});  // with the pack's extension
  const int c = threadIdx.x % 32;
  const int n_samples[2] = {svv, svs};
  for (int r = threadIdx.x / 32; r < H_RAYS; r += N_WARPS) {
    const int b = b0 + r;
    if (b >= B || c >= nc) break;
    Ray ray = load_ray(rays, B, b);
    attach_mat(ray, rays, B, b, mats);
    const TexMats tm = stage_tex(mats, ray.mat, rays, B, b, tex_rows(s_mat, M));
    const int n = n0 + c;
    float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
    if (ray.ok && s_vrl[VVALID * VRL_CHUNK + c] > 0.5f) {
      const VrlPair p = pair_at<false>(ray, s_vrl, c);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * (2 * svv + svs) : nullptr,
                        (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_terms<PHASE, SHORT_VRLS, true>(
          ray, p, m, draw, svv, svs, occl,
          [&](int family, const float* t) {
            const float lum = LUM_R * t[0] + LUM_G * t[1] + LUM_B * t[2];
            sum[family] += lum;
            sq[family] += lum * lum;
          },
          &tm);
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
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

template <int P, bool S, int MODE>
struct RTex {
  static auto kernel() { return &vrl_r_tex_kernel<P, S, MODE>; }
};

}  // namespace

extern "C" {

// Kernel 5's textured form, with alvrl_vrl_r's arguments (its `tex` set;
// modes 0 and 1).
int alvrl_vrl_r_tex(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                    const float* med, const float* mat_table, int M, const float* rt,
                    const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                    int phase_kind, float* planes, int mode, unsigned long long* counts,
                    float* out, void* stream) {
  const int n_chunks = (N + VRL_CHUNK - 1) / VRL_CHUNK;
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      n_chunks > MAX_GRID_Y || !tex_ok(mat_table, M, rt, mode, counts))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  const dim3 blocks((B + H_RAYS - 1) / H_RAYS, n_chunks);
  const size_t smem = (sweep_floats<true>(T) + VRL_ROWS * VRL_CHUNK + (size_t)M * MAT_COLS +
                       TEX_SMEM_FLOATS) *
                      sizeof(float);
  cudaError_t err = cudaSuccess;
  const int d = dispatch<true>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    const auto kernel = pick_tex<RTex>(phase, short_, mode);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<blocks, RAY_BLOCK, smem, (cudaStream_t)stream>>>(
          rays, B, vrls, N, tris, T, med, mat_table, M, rt, uniforms, seed, svv, svs, out,
          counts);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
