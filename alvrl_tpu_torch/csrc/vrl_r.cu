// Transfer matrix R, hand-written for Hopper (sm_90a).
//
// Its homogeneous form reads the medium pack with its extension and has
// a PHASE = 2 form for the mixture phase, as vrl_sum.cu's kernel 1.
//
// Its grid form also has a trilinear form (TRI, a medium of fast_tau
// False: the trilinear medium pack and the density itself, 8 corner
// reads and 7 lerps a lookup, vrl_common.cuh GridMedium<0, true>), which
// the JAX package's XLA route computes and its Pallas kernel does not
// (ROADMAP C20); its plain version is the same plain grid route with the
// trilinear read (integrate.py grid_density).
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
// 2,032 rays), is small beside that work. Each block takes a tile of
// rays x VRL_CHUNK VRLs, the triangles' plane pack and its VRL chunk in
// shared memory, with the lanes of a warp over the VRLs (one ray a warp
// at a time), so that a few hundred rays still fill the card, a warp's
// stores of out[b, n0 ..] are contiguous and each lane reads its own
// column of the staged VRL rows (no two lanes in a bank): every pair is
// one thread's loop step, and each pair's two outputs are written once,
// with no reduction across threads, so a repeat is bit-identical. Both
// sweep the shadow segments with kernel 1's plane pre-reject (PlaneTris)
// over the plane pack the C entry makes in front of the launch, and
// have its checking instantiation (MODE_CHECK).
//   * The homogeneous R (kernel 5): at config 2 (271 rays x 512 VRLs)
//     the old tile of RAY_BLOCK rays x VRL_CHUNK VRLs with a thread per
//     ray gave 3 x 16 = 48 blocks for 132 SMs, its neighbouring threads
//     storing N floats apart. Its tile is H_RAYS = 4 rays, one a warp
//     (68 x 16 = 1,088 blocks at config 2, 4 an SM); tiles of 8 and 16
//     rays measured 20-30 % slower on an H100 (PERF.md). Each thread
//     takes one pair, in a loop of its own, so that the grid R's code
//     stays as it is (its loop, unrolled over 4 pairs a thread, spilled
//     36 B in the homogeneous body).
//   * The grid R (kernel 6) fills the card at config 4's 2,032 x 512:
//     the old tile gave 16 x 16 = 256 blocks, at most 2 an SM. Its tile
//     is R_RAYS = 16 rays x VRL_CHUNK VRLs (2,032 blocks at config 4, 4
//     an SM), and the ray's eye-OD table, staged for the tile's rays in
//     shared memory (a row of NQ + 1 floats a ray), is read by the whole
//     warp at once. Tiles of 8 x 32 and 32 x 32 with lanes over VRLs,
//     and of 64 x 32 and 128 x 8 with lanes over rays, measured within
//     2-5 % of it on an H100 (PERF.md). It carries kernel 4's grid
//     items: the U-V step count a template argument (UV_STEPS; UV = 0
//     the generic count).
//
// Random numbers: Philox4x32-10 with key (seed, 0) and counter (p, n,
// call, 0), the draw order of vrl_sum.cu, so that sum_n mean[p, n] is the
// luminance of vrl_sum's out[:, p] on the same rays and seed (up to f32
// summation order). `uniforms`, when given, is read instead, as (P, N,
// 2 * svv + svs) float32.
// Both R kernels also have a material instantiation (MAT) for glossy and
// layered surfaces at the eye hit, as vrl_sum.cu's kernel 1
// (vrl_common.cuh eval_smooth; the grid one nearest or TRI at the
// run-time step count, ROADMAP C21); their lanes are VRLs against one
// ray, so a warp evaluates one material and does not diverge in the
// eval.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_r.cuh"

namespace {

using RKernel = void (*)(const float*, int, const float*, int, const float*, int, const float*,
                         GridArgs, const float*, int, const float*, const float*, uint32_t, int,
                         int, float*, unsigned long long*);

// The instantiation that a launch of these arguments takes (Tri: the
// grid kernel's trilinear form).
template <bool GRID, bool MAT = false, class Phase, class Short, class Uv,
          class Tri = std::false_type>
RKernel r_kernel(Phase, Short, Uv, int mode, Tri = {}) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  constexpr bool T = GRID && Tri::value;
  if (mode == MODE_CHECK) return &vrl_r_kernel<P, S, GRID, Uv::value, MODE_CHECK, MAT, T>;
  return &vrl_r_kernel<P, S, GRID, Uv::value, MODE_SUM, MAT, T>;
}

// dynamic shared memory of the R kernel, in bytes, with T triangles and M
// material rows
template <bool GRID>
size_t r_smem_bytes(int T, int M = 0) {
  return (sweep_floats<true>(T) + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
          (GRID ? GRID_MED_LEN + (NQ + 1) * R_RAYS : 0) + (size_t)M * MAT_COLS) *
         sizeof(float);
}

// Launches the R kernel on `stream`, after the plane pack of the T
// triangles into `planes` ((T, 4 PLANE_F4) floats of scratch), in `mode` (MODE_CHECK adds its counts to
// counts[N_CHECK]); returns a cudaError_t (0 = launched).
template <bool GRID>
int launch_r(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
             const float* med, GridArgs grid, int trilinear, const float* mat_table, int M,
             const float* rt,
             const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
             int phase_kind, float* planes, int mode, unsigned long long* counts, float* out,
             void* stream) {
  const int n_chunks = (N + VRL_CHUNK - 1) / VRL_CHUNK;
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      n_chunks > MAX_GRID_Y || !grid_ok<GRID>(grid) || !mode_ok<true>(mode, counts) ||
      !mats_ok(mat_table, M, rt))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  const dim3 blocks((B + r_tile_rays<GRID>() - 1) / r_tile_rays<GRID>(), n_chunks);
  const size_t smem = r_smem_bytes<GRID>(T, M);
  cudaError_t err = cudaSuccess;
  const int d = dispatch_read<GRID, true>(phase_kind, short_vrls, grid.uv_steps, trilinear,
                                          [&](auto phase, auto short_, auto uv, auto tri) {
    RKernel kernel = r_kernel<GRID, false>(phase, short_, uv, mode, tri);
    if (M > 0) {
      if constexpr (GRID)  // the grid material forms: the run-time step count
        kernel = r_kernel<GRID, true>(phase, short_, std::integral_constant<int, 0>{}, mode, tri);
      else
        kernel = r_kernel<GRID, true>(phase, short_, uv, mode);
    }
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

}  // namespace

extern "C" {

// The homogeneous R. `out` is (2, B, N); `uniforms` may be null (Philox
// stream from `seed`); `planes` (T, 4 PLANE_F4) float scratch for the
// triangles' plane pack (may be null for T = 0); mode 0 the R, 1 the
// checking instantiation (counts: N_CHECK totals, zeroed by the caller,
// as alvrl_vrl_sum's).
// mat_table, M and rt: the material table of the material instantiation,
// as alvrl_vrl_sum's (null, 0, null: the diffuse R); tex 1: its textured
// form (vrl_tex.cuh), as alvrl_vrl_sum's.
int alvrl_vrl_r(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                const float* med, const float* mat_table, int M, const float* rt, int tex,
                const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                int phase_kind, float* planes, int mode, unsigned long long* counts, float* out,
                void* stream) {
  if (tex)
    return alvrl_vrl_r_tex(rays, B, vrls, N, tris, T, med, mat_table, M, rt, uniforms, seed, svv,
                           svs, short_vrls, phase_kind, planes, mode, counts, out, stream);
  return launch_r<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, 0, mat_table, M, rt, uniforms,
                         seed, svv, svs, short_vrls, phase_kind, planes, mode, counts, out,
                         stream);
}

// The grid-medium R: the grid packs (ops/pack.py), the supersampled
// density (nz, ny, nx) and the U-V quadrature's step count (trilinear 1:
// the trilinear form, on the trilinear medium pack and the density
// itself, each extent at least 2); mat_table, M and rt: the material
// table of the material form (either read, the run-time step count;
// rays with the GRID_MATID row), or null, 0, null; tex 1 (with a table):
// the textured forms (vrl_r_grid_tex.cu), on the grid textured pack; the
// rest as alvrl_vrl_r.
int alvrl_vrl_r_hetero(const float* rays, int B, const float* vrls, int N, const float* tris,
                       int T, const float* med, const float* mat_table, int M, const float* rt,
                       int tex, const float* density, int nz, int ny, int nx, int uv_steps,
                       int trilinear, const float* uniforms, unsigned int seed, int svv, int svs,
                       int short_vrls, int phase_kind, float* planes, int mode,
                       unsigned long long* counts, float* out, void* stream) {
  if (tex)
    return alvrl_vrl_r_hetero_tex(rays, B, vrls, N, tris, T, med, mat_table, M, rt, density, nz,
                                  ny, nx, uv_steps, trilinear, uniforms, seed, svv, svs,
                                  short_vrls, phase_kind, planes, mode, counts, out, stream);
  if (trilinear && (nz < 2 || ny < 2 || nx < 2)) return (int)cudaErrorInvalidValue;
  return launch_r<true>(rays, B, vrls, N, tris, T, med, GridArgs{density, nz, ny, nx, uv_steps},
                        trilinear, mat_table, M, rt, uniforms, seed, svv, svs, short_vrls,
                        phase_kind, planes, mode, counts, out, stream);
}

// The rays of a tile of the R kernel (grid 0: homogeneous, 1: grid).
int alvrl_vrl_r_tile_rays(int grid) { return grid ? r_tile_rays<true>() : r_tile_rays<false>(); }

// The R kernel's blocks resident on one SM, as alvrl_vrl_sum_occupancy.
int alvrl_vrl_r_occupancy(int grid, int T, int uv_steps, int phase_kind, int short_vrls,
                          int* blocks) {
  return occupancy(
      grid, T, uv_steps, phase_kind, short_vrls, blocks,
      [](auto g, auto phase, auto short_, auto uv) {
        return r_kernel<decltype(g)::value>(phase, short_, uv, MODE_SUM);
      },
      [](auto g, int n_tris) { return r_smem_bytes<decltype(g)::value>(n_tris); });
}

}  // extern "C"
