// The textured forms of kernel 3, the grid VRL sum: vrl_sum.cuh's
// sum_block with TEX (vrl_sum.cu's material forms, vrl_sum_mat_kernel,
// nearest and trilinear, on the grid textured ray pack), hand-written for
// Hopper (sm_90a); see vrl_tex.cuh. In a source of its own, so that
// vrl_sum.cu keeps its machine code and the two compile side by side.
//
// Replaces, for a textured table in a grid medium,
// alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_hetero, whose ray pack gives
// a textured hit its untextured base albedo (ROADMAP C25); the port
// evaluates the texture, as the JAX package's XLA route does. Plain
// version: ops/vrl_sum.py vrl_sum_hetero_reference on the grid textured
// pack. Bound by fp32 ALU and SFU throughput, as kernel 3 (vrl_sum.cu's
// header); the textured rows add 12 floats a ray read once and the
// thread's three rows staged in shared memory (stage_tex_rows), which the
// vol-surf samples' evals read.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_sum.cuh"

namespace {

// sum_block<PHASE, SHORT_VRLS, true, 0, TRI, true, true>: the triangles,
// the VRL chunk with its OD rows, the medium, the eye-OD tables and the
// table in shared memory, then the threads' textured rows.
template <int PHASE, bool SHORT_VRLS, bool TRI>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_grid_tex_kernel(const float* __restrict__ rays, int B,
                            const float* __restrict__ vrls, int N,
                            const float* __restrict__ tris, int T,
                            const float* __restrict__ med, GridArgs grid,
                            const float* __restrict__ mat_table, int M,
                            const float* __restrict__ rt, const float* __restrict__ uniforms,
                            uint32_t seed, int svv, int svs, float* __restrict__ partial) {
  sum_block<PHASE, SHORT_VRLS, true, 0, TRI, true, true>(rays, B, vrls, N, tris, T, med, grid,
                                                         uniforms, seed, svv, svs, partial,
                                                         mat_table, M, rt);
}

}  // namespace

extern "C" {

// Kernel 3's textured forms, with alvrl_vrl_sum_hetero's arguments (its
// `tex` set; a table, either read, the run-time step count).
int alvrl_vrl_sum_hetero_tex(const float* rays, int B, const float* vrls, int N,
                             const float* tris, int T, const float* med,
                             const float* mat_table, int M, const float* rt,
                             const float* density, int nz, int ny, int nx, int uv_steps,
                             int trilinear, const float* uniforms, unsigned int seed, int svv,
                             int svs, int short_vrls, int phase_kind, float* partial,
                             int n_chunks, float* out, void* stream) {
  const GridArgs grid{density, nz, ny, nx, uv_steps};
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1) || n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK ||
      n_chunks > MAX_GRID_Y || !grid_ok<true>(grid) || !tex_ok(mat_table, M, rt, 0, nullptr) ||
      (trilinear && (nz < 2 || ny < 2 || nx < 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = ((size_t)T * TRI_COLS + GRID_VRL_ROWS * VRL_CHUNK + GRID_MED_LEN +
                       (NQ + 1) * RAY_BLOCK + (size_t)M * MAT_COLS + TEX_SMEM_FLOATS) *
                      sizeof(float);
  cudaError_t err = cudaSuccess;
  const int d = dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    constexpr int P = decltype(phase)::value;
    constexpr bool S = decltype(short_)::value;
    const auto kernel =
        trilinear ? &vrl_sum_grid_tex_kernel<P, S, true> : &vrl_sum_grid_tex_kernel<P, S, false>;
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, mat_table, M,
                                              rt, uniforms, seed, svv, svs, partial);
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
