// The textured forms of kernel 6, the grid transfer matrix R: vrl_r.cuh's
// vrl_r_kernel with TEX (the grid material forms, nearest and trilinear,
// on the grid textured ray pack), hand-written for Hopper (sm_90a); see
// vrl_tex.cuh. In a source of its own, so that vrl_r.cu keeps its machine
// code and the two compile side by side.
//
// Replaces, for a textured table in a grid medium,
// alvrl_tpu/ops/vrl_pallas.py:vrl_r_pallas_hetero, whose ray pack gives a
// textured hit its untextured base albedo (ROADMAP C25). Plain version:
// ops/vrl_r.py vrl_r_hetero_reference on the grid textured pack. Bound by
// fp32 ALU and SFU throughput, as kernel 6 (vrl_r.cu's header). Its tile
// is kernel 6's, R_RAYS rays x VRL_CHUNK VRLs with the lanes of a warp
// over the VRLs, so the 32 lanes of a ray share its rows: the block
// stages them once a ray of the tile (R_RAYS x 3 rows of MAT_COLS floats
// in shared memory, 3.75 KB), not once a thread as kernel 5's textured
// form does.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_r.cuh"

namespace {

// The form of (phase, short VRLs, mode, trilinear read).
template <int PHASE, bool SHORT_VRLS, int MODE, bool TRI>
constexpr auto r_tex_kernel() {
  return &vrl_r_kernel<PHASE, SHORT_VRLS, true, 0, MODE, true, TRI, true>;
}

}  // namespace

extern "C" {

// Kernel 6's textured forms, with alvrl_vrl_r_hetero's arguments (its
// `tex` set; a table, either read, the run-time step count; modes 0 and
// 1).
int alvrl_vrl_r_hetero_tex(const float* rays, int B, const float* vrls, int N, const float* tris,
                           int T, const float* med, const float* mat_table, int M,
                           const float* rt, const float* density, int nz, int ny, int nx,
                           int uv_steps, int trilinear, const float* uniforms,
                           unsigned int seed, int svv, int svs, int short_vrls, int phase_kind,
                           float* planes, int mode, unsigned long long* counts, float* out,
                           void* stream) {
  const GridArgs grid{density, nz, ny, nx, uv_steps};
  const int n_chunks = (N + VRL_CHUNK - 1) / VRL_CHUNK;
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      n_chunks > MAX_GRID_Y || !grid_ok<true>(grid) || !tex_ok(mat_table, M, rt, mode, counts) ||
      (trilinear && (nz < 2 || ny < 2 || nx < 2)))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  const dim3 blocks((B + R_RAYS - 1) / R_RAYS, n_chunks);
  const size_t smem = (sweep_floats<true>(T) + GRID_VRL_ROWS * VRL_CHUNK + GRID_MED_LEN +
                       (NQ + 1) * R_RAYS + (size_t)M * MAT_COLS + R_RAYS * TEX_ROW_FLOATS) *
                      sizeof(float);
  cudaError_t err = cudaSuccess;
  const int d = dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    constexpr int P = decltype(phase)::value;
    constexpr bool S = decltype(short_)::value;
    const auto kernel = mode == MODE_CHECK ? (trilinear ? r_tex_kernel<P, S, MODE_CHECK, true>()
                                                        : r_tex_kernel<P, S, MODE_CHECK, false>())
                                           : (trilinear ? r_tex_kernel<P, S, MODE_SUM, true>()
                                                        : r_tex_kernel<P, S, MODE_SUM, false>());
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<blocks, RAY_BLOCK, smem, (cudaStream_t)stream>>>(
          rays, B, vrls, N, tris, T, med, grid, mat_table, M, rt, uniforms, seed, svv, svs, out,
          counts);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
