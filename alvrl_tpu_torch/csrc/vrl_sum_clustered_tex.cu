// The textured form of kernel 2, the homogeneous clustered sum
// (vrl_sum_clustered.cu's material form on the textured ray pack),
// hand-written for Hopper (sm_90a); see vrl_tex.cuh.

#include "vrl_tex.cuh"

namespace {

// vrl_sum_clustered.cu's tile: C_RAYS rays, lane = ray, the block's
// warps over the row's columns
constexpr int C_RAYS = 32;
static_assert(RAY_BLOCK == N_WARPS * C_RAYS, "a warp a column");

// Kernel 2's textured form (vrl_sum_clustered.cu's
// vrl_sum_clustered_warps_kernel<PHASE, SHORT_VRLS, MODE, true>).
template <int PHASE, bool SHORT_VRLS, int MODE>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_clustered_tex_kernel(const float* __restrict__ rays, int B,
                                 const float* __restrict__ vrls, int N,
                                 const float* __restrict__ tris, int T,
                                 const float* __restrict__ med,
                                 const float* __restrict__ mat_table, int M,
                                 const float* __restrict__ rt,
                                 const int* __restrict__ tile_rays,
                                 const int* __restrict__ tile_row,
                                 const int* __restrict__ table_ids,
                                 const float* __restrict__ table_w, int C,
                                 const float* __restrict__ uniforms, uint32_t seed, int svv,
                                 int svs, float* __restrict__ out,
                                 unsigned long long* __restrict__ counts) {
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);  // sweep_floats<true>(T)
  float* s_vrl = s_tri + sweep_floats<true>(T);    // (VRL_ROWS, VRL_CHUNK)
  float* s_acc = s_vrl + VRL_ROWS * VRL_CHUNK;     // (N_WARPS, 3, C_RAYS)
  int* s_id = reinterpret_cast<int*>(s_acc + N_WARPS * 3 * C_RAYS);  // (VRL_CHUNK,)
  float* s_mat = reinterpret_cast<float*>(s_id + VRL_CHUNK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri, &cnt);
  const Mats mats = stage_mats(mat_table, M, rt, s_mat);
  __syncthreads();  // attach_mat and stage_tex read the rows

  const int tile = blockIdx.x;
  const int b = tile_rays[(size_t)tile * C_RAYS + lane];
  const int* ids = table_ids + (size_t)tile_row[tile] * C;
  const float* ws = table_w + (size_t)tile_row[tile] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  TexMats tm{};
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    attach_mat(ray, rays, B, b, mats);
    tm = stage_tex(mats, ray.mat, rays, B, b, tex_rows(s_mat, M));
  }
  const Medium m(med, std::true_type{});  // with the pack's extension
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < C; c0 += VRL_CHUNK) {
    __syncthreads();  // the previous piece is consumed (and the triangles staged)
    const int nc = stage_table_piece(vrls, N, VRL_ROWS, ids, ws, C, c0, s_vrl, s_id);
    __syncthreads();
    for (int cc = warp; ray.ok && cc < nc; cc += N_WARPS) {
      if (s_vrl[VVALID * VRL_CHUNK + cc] <= 0.5f) continue;
      const VrlPair p = pair_at<false>(ray, s_vrl, cc);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * C + c0 + cc) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)s_id[cc], seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_terms<PHASE, SHORT_VRLS, true>(
          ray, p, m, draw, svv, svs, occl,
          [&](int family, const float* t) {
            const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
          },
          &tm);
    }
  }

#pragma unroll
  for (int ch = 0; ch < 3; ++ch) s_acc[(warp * 3 + ch) * C_RAYS + lane] = acc[ch];
  __syncthreads();
  if (warp == 0 && b >= 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v = 0.0f;
      for (int w = 0; w < N_WARPS; ++w) v += s_acc[(w * 3 + ch) * C_RAYS + lane];
      out[(size_t)ch * B + b] = v;
    }
  }
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

template <int P, bool S, int MODE>
struct ClusteredTex {
  static auto kernel() { return &vrl_sum_clustered_tex_kernel<P, S, MODE>; }
};

}  // namespace

extern "C" {

// Kernel 2's textured form, with alvrl_vrl_sum_clustered's arguments (its
// `tex` set; modes 0 and 1; tiles of alvrl_clustered_ray_block(0) slots).
int alvrl_vrl_sum_clustered_tex(const float* rays, int B, const float* vrls, int N,
                                const float* tris, int T, const float* med,
                                const float* mat_table, int M, const float* rt,
                                const int* tile_rays, const int* tile_row, int n_tiles,
                                const int* table_ids, const float* table_w, int C,
                                const float* uniforms, unsigned int seed, int svv, int svs,
                                int short_vrls, int phase_kind, float* planes, int mode,
                                unsigned long long* counts, float* out, void* stream) {
  if (B <= 0 || N <= 0 || n_tiles <= 0 || C <= 0 || T < 0 || T > MAX_TRIS || svv < 0 ||
      svs < 0 || !tex_ok(mat_table, M, rt, mode, counts))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (sweep_floats<true>(T) + VRL_ROWS * VRL_CHUNK + N_WARPS * 3 * C_RAYS +
                       (size_t)M * MAT_COLS + TEX_SMEM_FLOATS) *
                          sizeof(float) +
                      VRL_CHUNK * sizeof(int);
  cudaError_t err = cudaSuccess;
  const int d = dispatch<true>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    const auto kernel = pick_tex<ClusteredTex>(phase, short_, mode);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, mat_table, M, rt,
                                               tile_rays, tile_row, table_ids, table_w, C,
                                               uniforms, seed, svv, svs, out, counts);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
