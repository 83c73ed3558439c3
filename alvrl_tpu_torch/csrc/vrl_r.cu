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

#include "vrl_common.cuh"

namespace {

constexpr float LUM_R = 0.212671f, LUM_G = 0.715160f, LUM_B = 0.072169f;  // Rec. 709

// the tiles, R_RAYS (grid) or H_RAYS (homogeneous) rays x VRL_CHUNK
// VRLs a block, the lanes of a warp over the VRLs (module comment)
constexpr int R_RAYS = 16, H_RAYS = 4;
static_assert((R_RAYS * VRL_CHUNK) % RAY_BLOCK == 0, "a tile of whole rounds");
static_assert(H_RAYS % N_WARPS == 0 && VRL_CHUNK == 32, "whole warps, a lane a VRL");

template <bool GRID>
__host__ __device__ constexpr int r_tile_rays() {
  return GRID ? R_RAYS : H_RAYS;
}

// The pair (ray b, VRL n = column c of the staged chunk): R's two
// numbers, written to out[:, b, n].
template <int PHASE, bool SHORT_VRLS, bool GRID, bool MAT, class Med, class Occl>
__device__ __forceinline__ void r_pair(const Ray& ray, int b, int B, int n, int N, int c,
                                       const float* s_vrl, const Med& m, const Occl& occl,
                                       const float* __restrict__ uniforms, uint32_t seed,
                                       int svv, int svs, float* __restrict__ out,
                                       const Mats* mats) {
  const int n_samples[2] = {svv, svs};
  float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
  if (ray.ok && s_vrl[VVALID * VRL_CHUNK + c] > 0.5f) {
    const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * (2 * svv + svs) : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS, MAT>(
        ray, p, m, draw, svv, svs, occl,
        [&](int family, const float* t) {
          const float lum = LUM_R * t[0] + LUM_G * t[1] + LUM_B * t[2];
          sum[family] += lum;
          sq[family] += lum * lum;
        },
        mats);
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

// tris: the triangles' plane pack, as sweep_floats<true>. MAT: the
// material instantiation (vrl_sum.cu's vrl_sum_plane_kernel), its M
// material rows staged after the VRL chunk (grid: after the eye-OD
// tables), each ray's material id read from its pack's MATID (grid:
// GRID_MATID) row.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, int MODE, bool MAT, bool TRI = false>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_r_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                 const float* __restrict__ tris, int T, const float* __restrict__ med,
                 GridArgs grid, const float* __restrict__ mat_table, int M,
                 const float* __restrict__ rt, const float* __restrict__ uniforms, uint32_t seed,
                 int svv, int svs, float* __restrict__ out,
                 unsigned long long* __restrict__ counts) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);     // sweep_floats<true>(T)
  float* s_vrl = s_tri + sweep_floats<true>(T);       // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;          // grid: (GRID_MED_LEN,)
  float* s_etab = s_med + (GRID ? GRID_MED_LEN : 0);  // grid: (R_RAYS, NQ + 1)
  float* s_mat = s_etab + (GRID ? (NQ + 1) * R_RAYS : 0);  // MAT: (M, MAT_COLS)
  const int b0 = blockIdx.x * r_tile_rays<GRID>(), n0 = blockIdx.y * VRL_CHUNK;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri, &cnt);
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl, V_ROWS);
  stage_medium<GRID>(med, s_med);
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, s_mat);
  if constexpr (GRID)  // each ray's eye-OD table, a row of NQ + 1 floats
    for (int i = threadIdx.x; i < R_RAYS * (NQ + 1); i += blockDim.x) {
      const int r = i % R_RAYS, k = i / R_RAYS;
      s_etab[r * (NQ + 1) + k] = b0 + r < B ? rays[(size_t)(EOD + k) * B + b0 + r] : 0.0f;
    }
  __syncthreads();

  // homogeneous: extended; TRI, the trilinear form of a grid medium of
  // fast_tau False (at UV 0)
  const auto m = make_medium<GRID, UV, !GRID, TRI>(med, s_med, grid);
  if constexpr (GRID) {
    // pair i of the tile: ray i / VRL_CHUNK, column i % VRL_CHUNK; a
    // thread takes every RAY_BLOCK-th
    for (int i = threadIdx.x; i < R_RAYS * VRL_CHUNK; i += RAY_BLOCK) {
      const int r = i / VRL_CHUNK, c = i % VRL_CHUNK;
      if (b0 + r >= B || c >= nc) continue;
      Ray ray = load_ray(rays, B, b0 + r);
      if constexpr (MAT) attach_mat<true>(ray, rays, B, b0 + r, mats);
      ray.eod = s_etab + r * (NQ + 1);
      ray.eod_stride = 1;
      r_pair<PHASE, SHORT_VRLS, GRID, MAT>(ray, b0 + r, B, n0 + c, N, c, s_vrl, m, occl,
                                           uniforms, seed, svv, svs, out,
                                           MAT ? &mats : nullptr);
    }
  } else {
    // ray r of the tile to warp r % N_WARPS, column c to lane c: the
    // grid loop's pairs, H_RAYS / N_WARPS a thread
    const int c = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < H_RAYS; r += N_WARPS) {
      const int b = b0 + r;
      if (b >= B || c >= nc) break;
      Ray ray = load_ray(rays, B, b);
      if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
      r_pair<PHASE, SHORT_VRLS, GRID, MAT>(ray, b, B, n0 + c, N, c, s_vrl, m, occl, uniforms,
                                           seed, svv, svs, out, &mats);
    }
  }
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

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
// rays with the GRID_MATID row), or null, 0, null; the rest as
// alvrl_vrl_r.
int alvrl_vrl_r_hetero(const float* rays, int B, const float* vrls, int N, const float* tris,
                       int T, const float* med, const float* mat_table, int M, const float* rt,
                       const float* density, int nz, int ny, int nx, int uv_steps,
                       int trilinear, const float* uniforms, unsigned int seed, int svv, int svs,
                       int short_vrls, int phase_kind, float* planes, int mode,
                       unsigned long long* counts, float* out, void* stream) {
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
