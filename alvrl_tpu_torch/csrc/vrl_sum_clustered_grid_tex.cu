// The textured forms of kernel 4, the grid clustered VRL sum:
// vrl_sum_clustered.cuh's vrl_sum_clustered_kernel with TEX (the grid
// material forms, nearest and trilinear, on the grid textured ray pack),
// hand-written for Hopper (sm_90a); see vrl_tex.cuh. In a source of its
// own, so that vrl_sum_clustered.cu keeps its machine code and the two
// compile side by side.
//
// Replaces, for a textured table in a grid medium,
// alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_hetero_clustered, whose ray
// pack gives a textured hit its untextured base albedo (ROADMAP C25).
// Plain version: ops/vrl_sum_clustered.py
// vrl_sum_hetero_clustered_reference on the grid textured pack. Bound by
// fp32 ALU and SFU throughput, as kernel 4 (vrl_sum_clustered.cu's
// header); each thread stages its ray's three textured rows in shared
// memory after the launch's table (stage_tex_rows).
// Precise math functions throughout (no --use_fast_math).

#include "vrl_sum_clustered.cuh"

namespace {

// The form of (phase, short VRLs, mode, trilinear read).
template <int PHASE, bool SHORT_VRLS, int MODE, bool TRI>
constexpr auto clustered_tex_kernel() {
  return &vrl_sum_clustered_kernel<PHASE, SHORT_VRLS, true, 0, MODE, TRI, true, true>;
}

}  // namespace

extern "C" {

// Kernel 4's textured forms, with alvrl_vrl_sum_hetero_clustered's
// arguments (its `tex` set; a table, either read, the run-time step
// count; modes 0 and 1).
int alvrl_vrl_sum_hetero_clustered_tex(const float* rays, int B, const float* vrls, int N,
                                       const float* tris, int T, const float* med,
                                       const float* mat_table, int M, const float* rt,
                                       const float* density, int nz, int ny, int nx,
                                       int uv_steps, int trilinear, const int* tile_rays,
                                       const int* tile_row, int n_tiles, const int* table_ids,
                                       const float* table_w, int C, const float* uniforms,
                                       unsigned int seed, int svv, int svs, int short_vrls,
                                       int phase_kind, float* planes, int mode,
                                       unsigned long long* counts, float* out, void* stream) {
  const GridArgs grid{density, nz, ny, nx, uv_steps};
  if (B <= 0 || N <= 0 || n_tiles <= 0 || C <= 0 || T < 0 || T > MAX_TRIS || svv < 0 ||
      svs < 0 || !grid_ok<true>(grid) || !tex_ok(mat_table, M, rt, mode, counts) ||
      (trilinear && (nz < 2 || ny < 2 || nx < 2)))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (sweep_floats<true>(T) + GRID_VRL_ROWS * VRL_CHUNK + GRID_MED_LEN +
                       (NQ + 1) * RAY_BLOCK + (size_t)M * MAT_COLS + TEX_SMEM_FLOATS) *
                          sizeof(float) +
                      VRL_CHUNK * sizeof(int);
  cudaError_t err = cudaSuccess;
  const int d = dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    constexpr int P = decltype(phase)::value;
    constexpr bool S = decltype(short_)::value;
    const auto kernel =
        mode == MODE_CHECK
            ? (trilinear ? clustered_tex_kernel<P, S, MODE_CHECK, true>()
                         : clustered_tex_kernel<P, S, MODE_CHECK, false>())
            : (trilinear ? clustered_tex_kernel<P, S, MODE_SUM, true>()
                         : clustered_tex_kernel<P, S, MODE_SUM, false>());
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, tile_rays,
                                               tile_row, table_ids, table_w, C, uniforms, seed,
                                               svv, svs, out, counts, mat_table, M, rt);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
