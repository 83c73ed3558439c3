// The textured form of kernel 1, the homogeneous VRL sum (vrl_sum.cu's
// material form on the textured ray pack), hand-written for Hopper
// (sm_90a); see vrl_tex.cuh.

#include "vrl_tex.cuh"

namespace {
// Kernel 1's textured form (vrl_sum.cu's vrl_sum_plane_kernel<PHASE,
// SHORT_VRLS, MODE, true>): the plane pack, the VRL chunk and the table
// in shared memory, then the threads' rows.
template <int PHASE, bool SHORT_VRLS, int MODE>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_tex_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float4* __restrict__ planes, int T,
                       const float* __restrict__ med, const float* __restrict__ mat_table, int M,
                       const float* __restrict__ rt, const float* __restrict__ uniforms,
                       uint32_t seed, int svv, int svs, float* __restrict__ partial,
                       unsigned long long* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  float4* s_planes = smem4;  // (T * PLANE_F4)
  float* s_vrl = reinterpret_cast<float*>(smem4 + T * PLANE_F4);
  float* s_mat = s_vrl + VRL_ROWS * VRL_CHUNK;
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  for (int i = threadIdx.x; i < T * PLANE_F4; i += blockDim.x) s_planes[i] = planes[i];
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl);
  const Mats mats = stage_mats(mat_table, M, rt, s_mat);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Ray ray = load_ray(rays, B, b);
  attach_mat(ray, rays, B, b, mats);
  const TexMats tm = stage_tex(mats, ray.mat, rays, B, b, tex_rows(s_mat, M));
  const Medium m(med, std::true_type{});  // with the pack's extension
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const PlaneTris<MODE> occl{s_planes, T, &cnt};

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray.ok && c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
    const int n = n0 + c;
    const VrlPair p = pair_at<false>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS, true>(
        ray, p, m, draw, svv, svs, occl,
        [&](int family, const float* t) {
          const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
        },
        &tm);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

template <int P, bool S, int MODE>
struct SumTex {
  static auto kernel() { return &vrl_sum_tex_kernel<P, S, MODE>; }
};

}  // namespace

extern "C" {

// Kernel 1's textured form, with alvrl_vrl_sum's arguments (its `tex`
// set; modes 0 and 1).
int alvrl_vrl_sum_tex(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                      const float* med, const float* mat_table, int M, const float* rt,
                      const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                      int phase_kind, float* planes, int mode, unsigned long long* counts,
                      float* partial, int n_chunks, float* out, void* stream) {
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK || n_chunks > MAX_GRID_Y ||
      !tex_ok(mat_table, M, rt, mode, counts))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = (size_t)T * PLANE_F4 * sizeof(float4) +
                      ((size_t)VRL_ROWS * VRL_CHUNK + (size_t)M * MAT_COLS + TEX_SMEM_FLOATS) *
                          sizeof(float);
  cudaError_t err = cudaSuccess;
  const int d = dispatch<true>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    const auto kernel = pick_tex<SumTex>(phase, short_, mode);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N,
                                              reinterpret_cast<const float4*>(tris), T, med,
                                              mat_table, M, rt, uniforms, seed, svv, svs,
                                              partial, counts);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<float><<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
