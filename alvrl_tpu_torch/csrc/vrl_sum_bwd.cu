// VJP of the VRL x eye-ray sum (vrl_sum.cu), hand-written for Hopper
// (sm_90a), for homogeneous and grid media.
//
// Replaces alvrl_tpu/ops/vrl_pallas_bwd.py:vrl_sum_pallas_bwd (its body
// `_bwd_kernel` with hetero=False, clustered=False; entry point
// alvrl_vrl_sum_bwd) and, for grid media, vrl_sum_pallas_hetero_bwd
// (hetero=True; entry point alvrl_vrl_sum_hetero_bwd). Given the output
// cotangent gbar (3, B), it replays the forward's samples (the same
// Philox counters (b, n, call) or injected uniforms, in the same draw
// order, through pair_samples of vrl_common.cuh) and accumulates
//   d_power (3, N)  per VRL, summed over the rays;
//   d_par           the medium pack's cotangents: homogeneous (8,):
//                   sigma_t 0:3, sigma_s 3:6, g 6, and 0 at 7; grid
//                   (GRID_MED_LEN,): sigma_t_color 0:3, sigma_s_color
//                   3:6, g 6, chan 7, the density scale 17, 0 elsewhere;
//   d_tau   (3, B)  per ray, summed over the VRLs;
// and for grid media
//   d_eod   (NQ + 1, B)  the eye-OD table entries of each ray;
//   d_vod   (NQ + 1, N)  the VRL-OD table entries of each VRL;
//   d_density (nz, ny, nx)  the supersampled density grid: one scatter
//                   per density read of a term (at U, at V, and at each
//                   U-V quadrature step), through the same voxel index
//                   as the forward's read (GridMedium::voxel).
// The TPU kernel's CP-factor cotangents (d_fac) have no counterpart: the
// port reads the grid directly (ROADMAP C9), and d_density is the exact
// derivative of its forward. Plain PyTorch twins:
// ops/vrl_sum_bwd.py:vrl_sum_bwd_reference and
// vrl_sum_hetero_bwd_reference.
// Its material forms (a glossy or layered table), extended forms (the
// mixture phase, a strategy's rate) and trilinear forms (fast_tau False)
// differentiate what the forward's forms render, as the JAX package's
// XLA route does; its Pallas backward takes none of them (ROADMAP C22).
//
// Every cotangent is a product of the other factors of the term, never
// the term divided by the value it differentiates (vol_vol_cot,
// vol_surf_cot in vrl_common.cuh): the reference's quotients are 0
// wherever that channel of power, sigma_s or tau is 0, though the term is
// linear in it (ROADMAP C7).
//
// What bounds it: as the forward, fp32 ALU and SFU instruction throughput per
// pair-sample (the replay costs the forward's samples; the cotangents
// add a few dozen flops and one phase derivative per sample; a grid
// sample adds its table and voxel scatters, about a tenth of the grid
// instantiation's time at config 4 in the ablations of
// scripts/time_kernels.py --grid-split). Tensor cores, wgmma and TMA do
// not apply: per-pair scalar math, gathers and scattered adds. The grid
// instantiation takes the U-V quadrature's step count as a template
// argument, as the forward's (4, every caller's; UV = 0 the generic
// run-time count): its steps' voxels and raw densities are read once,
// into registers, for the optical depth, the scatters and d_scale alike
// (the generic instantiation recomputes them for the scatters), and
// consecutive reads of one voxel on a sample's path (U, the steps, V)
// are merged into one reduction (about 9 % faster on the trainer's 31^3
// grid, 0.5 % slower on config 4's 95^3: PERF.md). The eye-OD table is staged per thread
// in shared memory as in the forward. Aggregating the reductions
// across a warp (__match_any_sync) cost far more than it saved and was
// left out (PERF.md). The homogeneous instantiations (kernel 8) sweep
// the shadow segments as kernel 1 does (vrl_common.cuh PlaneTris: a
// plane pre-reject with a proven margin, then the Wald tests of the
// triangles it keeps, from a plane pack in shared memory made in front
// of the kernel by vrl_sum.cu's plane_pack_kernel), which decides every
// segment as the flat sweep does: the replay's shadow tests were 55 %
// of its time at the config-1 train step (PERF.md). The grid
// instantiations keep the flat sweep (FlatTris). Every instantiation is
// held to 128 registers (BWD_MIN_BLOCKS, 4 blocks an SM). The design
// follows the forward's grid (RAY_BLOCK rays x VRL_CHUNK VRLs per block)
// and reduces everything but d_density with no atomics, in a fixed
// order, so a repeat is bit-identical there:
//   * per ray (d_tau, and d_eod from a column of shared memory per
//     thread): each thread sums its ray's cotangents over the block's
//     VRLs into (n_chunks, 3 [+ NQ + 1], B) partials, added in chunk
//     order;
//   * per VRL (d_power, and d_vod from a second per-thread column,
//     cleared for each VRL): after each VRL, the block's rays are summed
//     by warp shuffles (a fixed butterfly) and the warps in order, into
//     (n_ray_blocks, 3 [+ NQ + 1], N) partials, added in ray-block order
//     (grid media: in float64, since these sums over 2,048 ray blocks at
//     config 4 cancel and their float32 rounding reached the 1e-5 bar,
//     ROADMAP C12);
//   * d_par: each block sums its threads the same way into (n_blocks,
//     n_par) partials, added by a fixed tree;
//   * d_density: atomicAdd onto the grid (zeroed first), with the result
//     unused so that it compiles to a reduction (RED); reads outside the
//     box (forced to 0) and cotangents of exactly 0 add nothing. The
//     order of the adds varies between runs, so a repeat agrees to
//     float32 rounding of each voxel's sum, not bit for bit.
// Threads past the last ray stay in the loop (with no samples) so that
// every lane takes part in the shuffles.

#include "vrl_common.cuh"

namespace {

// tris: the triangles, TRI_COLS floats each (grid media) or their plane
// pack (homogeneous), as sweep_floats<!GRID>. The forms beside the
// diffuse ones (each a template argument, the body here for all, so that
// the diffuse forms keep their code): EXT, the homogeneous medium pack
// with its extension (the mixture, PHASE 2, and the strategy's rate;
// kernel 8's extended forms, whose d_par ends at the rate's entry);
// TRI, the grid medium's trilinear read (kernel 9's trilinear forms, at
// the run-time step count, UV = 0); MAT, the material forms, which stage
// the M rows of mat_table after the eye-OD tables and evaluate the eye
// hit's smooth BSDF in the vol-surf cotangents (rt: the rough-
// transmittance tables). MAT = false ignores mat_table, M and rt.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, bool EXT = false, bool TRI = false,
          bool MAT = false>
__global__ void __launch_bounds__(RAY_BLOCK, BWD_MIN_BLOCKS)
    vrl_sum_bwd_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float* __restrict__ tris, int T,
                       const float* __restrict__ med, GridArgs grid,
                       const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                       const float* __restrict__ gbar, float* __restrict__ ray_part,
                       float* __restrict__ vrl_part, float* __restrict__ par_part,
                       float* __restrict__ d_density, const float* __restrict__ mat_table,
                       int M, const float* __restrict__ rt) {
  using L = Layout<GRID, EXT>;
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);        // sweep_floats<!GRID>(T)
  float* s_vrl = s_tri + sweep_floats<!GRID>(T);         // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;             // grid: (GRID_MED_LEN,)
  float* s_out = s_med + (GRID ? GRID_MED_LEN : 0);      // (N_WARPS, ROWS, VRL_CHUNK)
  float* s_par = s_out + N_WARPS * L::ROWS * VRL_CHUNK;  // (N_WARPS, N_SUMS)
  float* s_eod = s_par + N_WARPS * L::N_SUMS;            // grid: (N_OD, RAY_BLOCK)
  float* s_vod = s_eod + L::N_OD * RAY_BLOCK;            // grid: (N_OD, RAY_BLOCK)
  float* s_etab = s_vod + L::N_OD * RAY_BLOCK;           // grid: (N_OD, RAY_BLOCK)
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  const int t = threadIdx.x;
  const auto occl = stage_sweep<!GRID>(tris, T, s_tri);
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl, V_ROWS);
  stage_medium<GRID>(med, s_med);
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, s_etab + L::N_OD * RAY_BLOCK);
  for (int i = t; i < N_WARPS * L::ROWS * VRL_CHUNK; i += blockDim.x) s_out[i] = 0.0f;
  for (int k = 0; k < L::N_OD; ++k) s_eod[k * RAY_BLOCK + t] = 0.0f;  // this thread's column
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + t;
  const bool in_range = b < B;
  Ray ray{};
  Cot c{};
  if (in_range) {
    ray = load_ray(rays, B, b);
    if constexpr (MAT) attach_mat<GRID>(ray, rays, B, b, mats);
    stage_eod<GRID>(ray, rays, B, b, s_etab);
    for (int ch = 0; ch < 3; ++ch) c.gb[ch] = gbar[(size_t)ch * B + b];
  }
  c.d_eod = s_eod + t;
  c.d_vod = s_vod + t;
  c.d_density = d_density;
  const auto m = make_medium<GRID, UV, EXT, TRI>(med, s_med, grid);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  for (int cc = 0; cc < nc; ++cc) {
    if (s_vrl[VVALID * VRL_CHUNK + cc] <= 0.5f) continue;  // the same for the whole block
    clear_pair_cots<GRID>(c);
    if (ray.ok) {
      const int n = n0 + cc;
      const VrlPair p = pair_at<GRID>(ray, s_vrl, cc);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_cots<PHASE, SHORT_VRLS, EXT, MAT>(ray, p, m, draw, svv, svs, occl, inv_vv, inv_vs, c,
                                             &mats);
    }
    warp_column_sums<GRID>(c, s_out, cc);
  }

  if (in_range) {
#pragma unroll
    for (int r = 0; r < L::ROWS; ++r)
      ray_part[((size_t)chunk * L::ROWS + r) * B + b] =
          r < 3 ? c.d_tau[r] : c.d_eod[(r - 3) * RAY_BLOCK];
  }
  block_par_sums<GRID, EXT>(c, s_par, par_part, (size_t)blockIdx.y * gridDim.x + blockIdx.x);

  for (int i = t; i < L::ROWS * VRL_CHUNK; i += blockDim.x) {
    const int r = i / VRL_CHUNK, cc = i % VRL_CHUNK;
    if (cc < nc)
      vrl_part[((size_t)blockIdx.x * L::ROWS + r) * N + n0 + cc] =
          block_column_sum<GRID>(s_out, r, cc);
  }
}

// dynamic shared memory of the backward, in bytes, with T triangles, M
// material rows (0 but for the material forms) and the pack's extension
// (ext, homogeneous)
template <bool GRID>
size_t bwd_smem_bytes(int T, int M = 0, bool ext = false) {
  const size_t floats = ext ? Layout<GRID, true>::smem_floats(sweep_floats<!GRID>(T))
                            : Layout<GRID>::smem_floats(sweep_floats<!GRID>(T));
  return (floats + (size_t)M * MAT_COLS) * sizeof(float);
}

// The instantiation of the backward for one launch.
using BwdKernel = void (*)(const float*, int, const float*, int, const float*, int, const float*,
                           GridArgs, const float*, uint32_t, int, int, const float*, float*,
                           float*, float*, float*, const float*, int, const float*);

// The backward's instantiation for (phase, short VRLs, uv) as dispatch
// gives them and the form: ext (homogeneous: the pack's extension; the
// mixture, PHASE 2, has no other), tri (grid: the trilinear read), mat
// (the material form). The trilinear and material grid forms take the
// run-time step count (UV 0), as the forward's.
template <bool GRID, class Phase, class Short, class Uv>
BwdKernel bwd_kernel(Phase, Short, Uv, bool ext, bool tri, bool mat) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  if constexpr (GRID) {
    if (tri)
      return mat ? &vrl_sum_bwd_kernel<P, S, true, 0, false, true, true>
                 : &vrl_sum_bwd_kernel<P, S, true, 0, false, true, false>;
    if (mat) return &vrl_sum_bwd_kernel<P, S, true, 0, false, false, true>;
    return &vrl_sum_bwd_kernel<P, S, true, Uv::value>;
  } else if constexpr (P == 2) {
    return mat ? &vrl_sum_bwd_kernel<2, S, false, 0, true, false, true>
               : &vrl_sum_bwd_kernel<2, S, false, 0, true, false, false>;
  } else {
    if (ext)
      return mat ? &vrl_sum_bwd_kernel<P, S, false, 0, true, false, true>
                 : &vrl_sum_bwd_kernel<P, S, false, 0, true, false, false>;
    return mat ? &vrl_sum_bwd_kernel<P, S, false, 0, false, false, true>
               : &vrl_sum_bwd_kernel<P, S, false, 0>;
  }
}

// Launches the backward and its three ordered reductions on `stream`
// (homogeneous: after the plane pack of the triangles into `planes`,
// (T, 4 PLANE_F4) floats of scratch; grid media: after zeroing
// d_density); returns a cudaError_t (0 = launched). The form: ext
// (homogeneous: the medium pack with its extension, the mixture phase
// kind PHASE_MIXTURE allowed), trilinear (grid), and M > 0 the material
// table mat_table, M, rt. Scratch: ray_part (n_chunks, ROWS, B),
// vrl_part (n_ray_blocks, ROWS, N), par_part (n_ray_blocks * n_chunks,
// n_par). Out: d_ray (ROWS, B) = d_tau [, d_eod], d_vrl (ROWS, N) =
// d_power [, d_vod], d_par (n_par,: 8, MED_RHO + 1 with ext, or
// GRID_MED_LEN) and, for grid media, d_density (nz, ny, nx).
template <bool GRID>
int launch_bwd(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
               const float* med, GridArgs grid, int trilinear, const float* mat_table, int M,
               const float* rt, int ext, const float* uniforms, unsigned int seed, int svv,
               int svs, int short_vrls, int phase_kind, const float* gbar, float* planes,
               float* ray_part, int n_chunks, float* vrl_part, int n_ray_blocks, float* par_part,
               float* d_vrl, float* d_par, float* d_ray, float* d_density, void* stream) {
  const int rows = GRID ? Layout<true>::ROWS : Layout<false>::ROWS;
  const int n_par = ext ? Layout<false, true>::N_PAR_OUT : Layout<GRID>::N_PAR_OUT;
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1 && !(ext && phase_kind == PHASE_MIXTURE)) ||
      (GRID && ext) || (!GRID && trilinear) || n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK ||
      n_chunks > MAX_GRID_Y || n_ray_blocks != (B + RAY_BLOCK - 1) / RAY_BLOCK ||
      !grid_ok<GRID>(grid) || (GRID && d_density == nullptr) || !mats_ok(mat_table, M, rt))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<!GRID>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  if (GRID) {
    const cudaError_t err = cudaMemsetAsync(
        d_density, 0, (size_t)grid.nz * grid.ny * grid.nx * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 blocks(n_ray_blocks, n_chunks);
  const size_t smem = bwd_smem_bytes<GRID>(T, M, ext);
  cudaError_t attr = cudaSuccess;
  dispatch<GRID, true>(phase_kind, short_vrls, grid.uv_steps,
                       [&](auto phase, auto short_, auto uv) {
                         const BwdKernel kernel =
                             bwd_kernel<GRID>(phase, short_, uv, ext, trilinear, M > 0);
                         attr = allow_smem(kernel, smem);
                         if (attr == cudaSuccess)
                           kernel<<<blocks, RAY_BLOCK, smem, st>>>(
                               rays, B, vrls, N, tris, T, med, grid, uniforms, seed, svv, svs,
                               gbar, ray_part, vrl_part, par_part, d_density, mat_table, M, rt);
                       });
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts<float>
      <<<(rows * B + 255) / 256, 256, 0, st>>>(ray_part, n_chunks, rows * B, d_ray);
  // the grid's per-VRL sums (d_power, d_vod) over its ray blocks in
  // float64: long sums of both signs (ROADMAP C12)
  reduce_parts<std::conditional_t<GRID, double, float>>
      <<<(rows * N + 255) / 256, 256, 0, st>>>(vrl_part, n_ray_blocks, rows * N, d_vrl);
  reduce_parts_tree<<<n_par, TREE, 0, st>>>(par_part, n_ray_blocks * n_chunks, n_par, d_par);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int alvrl_ray_block() { return RAY_BLOCK; }

// The homogeneous backward. mat_table (M, MAT_COLS), M and rt (M,
// RT_COS, RT_ALPHA): the material form (null, 0, null: the diffuse one),
// on rays carrying the hit's material id in row MATID; ext: the medium
// pack with its extension (ops/pack.py pack_medium; the mixture phase,
// a strategy's rate), d_par then MED_RHO + 1 long. Scratch: planes (T, 4
// PLANE_F4) for the triangles' plane pack (may be null for T = 0),
// tau_part (n_chunks, 3, B), pw_part (n_ray_blocks, 3, N), par_part
// (n_ray_blocks * n_chunks, n_par). Out: d_power (3, N), d_par (8, or
// MED_RHO + 1), d_tau (3, B). `uniforms` may be null (the Philox stream
// of `seed`, as the forward's).
int alvrl_vrl_sum_bwd(const float* rays, int B, const float* vrls, int N, const float* tris,
                      int T, const float* med, const float* mat_table, int M, const float* rt,
                      int ext, const float* uniforms, unsigned int seed, int svv, int svs,
                      int short_vrls, int phase_kind, const float* gbar, float* planes,
                      float* tau_part, int n_chunks, float* pw_part, int n_ray_blocks,
                      float* par_part, float* d_power, float* d_par, float* d_tau, void* stream) {
  return launch_bwd<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, 0, mat_table, M, rt, ext,
                           uniforms, seed, svv, svs, short_vrls, phase_kind, gbar, planes,
                           tau_part, n_chunks, pw_part, n_ray_blocks, par_part, d_power, d_par,
                           d_tau, nullptr, stream);
}

// The grid-medium backward: the grid packs (ops/pack.py), the
// supersampled density (nz, ny, nx) and the U-V quadrature's step count,
// as alvrl_vrl_sum_hetero takes them, with `trilinear` the trilinear
// form (the trilinear medium pack, the density itself) and the material
// table as alvrl_vrl_sum_bwd's (rays carrying the id in row GRID_MATID).
// Scratch: ray_part (n_chunks, 3 + NQ + 1, B), vrl_part (n_ray_blocks,
// 3 + NQ + 1, N), par_part (n_ray_blocks * n_chunks, GRID_MED_LEN). Out:
// d_vrl (3 + NQ + 1, N) = d_power, d_vod; d_par (GRID_MED_LEN,); d_ray
// (3 + NQ + 1, B) = d_tau, d_eod; d_density (nz, ny, nx), zeroed here
// first.
int alvrl_vrl_sum_hetero_bwd(const float* rays, int B, const float* vrls, int N,
                             const float* tris, int T, const float* med, const float* mat_table,
                             int M, const float* rt, const float* density, int nz, int ny, int nx,
                             int uv_steps, int trilinear, const float* uniforms,
                             unsigned int seed, int svv, int svs, int short_vrls, int phase_kind,
                             const float* gbar, float* ray_part, int n_chunks, float* vrl_part,
                             int n_ray_blocks, float* par_part, float* d_vrl, float* d_par,
                             float* d_ray, float* d_density, void* stream) {
  return launch_bwd<true>(rays, B, vrls, N, tris, T, med, GridArgs{density, nz, ny, nx, uv_steps},
                          trilinear, mat_table, M, rt, 0, uniforms, seed, svv, svs, short_vrls,
                          phase_kind, gbar, nullptr, ray_part, n_chunks, vrl_part, n_ray_blocks,
                          par_part, d_vrl, d_par, d_ray, d_density, stream);
}

// The backward's blocks resident on one SM, as alvrl_vrl_sum_occupancy
// (the diffuse forms).
int alvrl_vrl_sum_bwd_occupancy(int grid, int T, int uv_steps, int phase_kind, int short_vrls,
                                int* blocks) {
  return occupancy(
      grid, T, uv_steps, phase_kind, short_vrls, blocks,
      [](auto g, auto phase, auto short_, auto uv) {
        return &vrl_sum_bwd_kernel<decltype(phase)::value, decltype(short_)::value,
                                   decltype(g)::value, decltype(uv)::value>;
      },
      [](auto g, int n_tris) { return bwd_smem_bytes<decltype(g)::value>(n_tris); });
}

}  // extern "C"
