// VJP of the clustered VRL sum (vrl_sum_clustered.cu), hand-written for
// Hopper (sm_90a), for homogeneous and grid media.
//
// Replaces alvrl_tpu/ops/vrl_pallas_bwd.py:vrl_sum_pallas_clustered_bwd
// (its body `_bwd_kernel` with clustered=True, hetero=False; entry point
// alvrl_vrl_sum_clustered_bwd) and vrl_sum_pallas_hetero_clustered_bwd
// (hetero=True; alvrl_vrl_sum_hetero_clustered_bwd), with the per-slice
// scatter-add of their table cotangents (vrl_sum_clustered_diff,
// vrl_sum_hetero_clustered_diff). Given the output cotangent gbar (3, B)
// it replays the clustered forward's samples (the same tiles, the same
// table pieces staged by vrl_common.cuh's stage_table_piece, the same
// Philox counters (b, VRL id, call) or injected uniforms indexed by ray
// and table column) through vrl_sum_bwd.cu's cotangents (pair_cots), and
// returns
//   d_tau   (3, B)  per ray, and in a grid medium d_eod (NQ + 1, B);
//   d_par           the medium pack's cotangents, as vrl_sum_bwd.cu's;
//   d_weights (S, C) the table weights';
//   d_power (3, N)  per VRL, and in a grid medium d_vod (NQ + 1, N);
//   d_density       grid media: the supersampled grid's, as
//                   vrl_sum_bwd.cu's (one scatter per density read).
// The reference returns per-tile cotangents of its materialised tables
// (weights folded into the power rows), which its caller adds per slice
// and chains through the table build. The port's tables are VRL ids and
// weights over the full pack, so the chain is here: with d_table (S,
// ROWS, C) the per-row sums of the tiles' column cotangents,
//   d_weights[s, c] = sum_ch d_table[s, ch, c] power[ch, id],
//   d_power[:, id] += w[s, c] d_table[s, :3, c],
//   d_vod[:, id]   += d_table[s, 3:, c],
// and a column that is not valid (column_valid: an id outside [0, N), an
// invalid VRL, or w <= 0) gives nothing, as the reference's valid =
// vrls.valid[idx] & (tw > 0) (integrator.py:412). Plain PyTorch twins:
// ops/vrl_sum_clustered_bwd.py:vrl_sum_clustered_bwd_reference and
// vrl_sum_hetero_clustered_bwd_reference.
// Its material forms (a glossy or layered table), extended forms (the
// mixture phase, a strategy's rate) and trilinear forms (fast_tau False)
// differentiate what the forward's forms render, as the JAX package's
// XLA route does; its Pallas backward takes none of them (ROADMAP C22).
//
// What bounds it: as the clustered forward, fp32 ALU and SFU work per
// pair-sample; the replay costs the forward's samples and the
// cotangents add vrl_sum_bwd.cu's work per sample. Every instantiation
// is held to 128 registers (BWD_MIN_BLOCKS, 4 blocks an SM). Each block
// takes one tile of rays of one table row (group_by_slice's tiles,
// contiguous per row) and loops over the row's table in VRL_CHUNK
// pieces; the two media take two tilings:
//   * homogeneous (kernel 10): at config 2 (16,384 rays, 100 x 19
//     tables) the clustered forward's tiles of RAY_BLOCK rays were 164
//     blocks, about 1.2 an SM, a fifth of their lanes padding. A tile
//     here is CB_RAYS = 32 rays, a warp's lanes over them, and the
//     block's N_WARPS warps over the row's columns (column c of a piece
//     to warp c % N_WARPS): 542 tiles at config 2, 5.5 % padding.
//     It sweeps kernel 1's plane pack with the plane pre-reject
//     (PlaneTris<MODE_SUM>), made by the C entry in front of the launch;
//     the same tiling with the pack's flat sweep (MODE_NO_REJECT) is its
//     checking launch, whose outputs must be bit-identical. 128-ray
//     tiles with each row's columns split over 4 blocks, whose per-ray
//     partials a second pass adds in order, measured 9-10 % slower on
//     an H100 (PERF.md).
//   * grid (kernel 11): it fills the card with the forward's tiles of
//     RAY_BLOCK rays (2,096 at config 4), each thread a ray walking the
//     row's columns, and is built as the unclustered grid VJP: the U-V
//     quadrature's step count a template argument (4, every caller's;
//     UV = 0 the generic run-time count), so that the steps' voxels and
//     raw densities are read once and consecutive reads of one voxel
//     merged into one reduction (vrl_common.cuh density_cots); the ray's
//     eye-OD table staged per thread in shared memory (stage_eod); the
//     flat sweep (FlatTris).
// Everything but d_density is summed in a fixed order, so a repeat is
// bit-identical there:
//   * per ray (d_tau, d_eod): each ray lies in exactly one tile. Grid:
//     its thread writes its sums over the row's columns straight to its
//     column of the output; homogeneous: each warp's sums over its
//     columns, added in warp order through shared memory. The output is
//     zeroed first for rays in no tile: no partials, no atomics;
//   * per column (d_table): each column's sum over the tile's rays (grid:
//     warp shuffles, then the warps in order; homogeneous: one warp's
//     shuffles) goes once into per-tile partials (n_tiles, ROWS, C);
//     table_sums adds each row's tiles in tile order (row_tiles gives
//     each row's first tile, for any number of tiles per row) and forms
//     d_weights;
//   * per VRL (d_power, d_vod): vrl_sums adds the table slots that hold
//     each VRL in slot order (slots, slot_start: a CSR of the slots by
//     id, built on the host with the tiles);
//   * d_par: per-block partials, added by reduce_parts_tree;
//   * d_density: atomicAdd with its result unused (RED), zeroed first;
//     a repeat agrees to float32 rounding of each voxel's sum.
// Padding slots of a tile stay in the loop with no samples so that every
// lane takes part in the shuffles.

#include "vrl_common.cuh"

namespace {

// rays of a homogeneous tile: one warp's lanes (module comment)
constexpr int CB_RAYS = 32;
static_assert(RAY_BLOCK == N_WARPS * CB_RAYS, "a warp a column");

// The homogeneous backward (kernel 10): tile blockIdx.x, CB_RAYS rays of
// one row (lane = ray), the warps over the row's columns; tris: the
// triangles' plane pack, swept by PlaneTris<MODE> (MODE_SUM, or
// MODE_NO_REJECT, the checking launch). EXT: the medium pack with its
// extension (the mixture, PHASE 2, and the strategy's rate; d_par then
// ends at the rate's entry); MAT: the material form, its M table rows
// staged after the piece's ids (MAT = false ignores mat_table, M, rt).
template <int PHASE, bool SHORT_VRLS, int MODE, bool EXT = false, bool MAT = false>
__global__ void __launch_bounds__(RAY_BLOCK, BWD_MIN_BLOCKS)
    vrl_sum_clustered_bwd_warps_kernel(const float* __restrict__ rays, int B,
                                       const float* __restrict__ vrls, int N,
                                       const float* __restrict__ tris, int T,
                                       const float* __restrict__ med,
                                       const int* __restrict__ tile_rays,
                                       const int* __restrict__ tile_row,
                                       const int* __restrict__ table_ids,
                                       const float* __restrict__ table_w, int C,
                                       const float* __restrict__ uniforms, uint32_t seed,
                                       int svv, int svs, const float* __restrict__ gbar,
                                       float* __restrict__ d_ray, float* __restrict__ tile_part,
                                       float* __restrict__ par_part,
                                       const float* __restrict__ mat_table, int M,
                                       const float* __restrict__ rt) {
  using L = Layout<false, EXT>;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);     // sweep_floats<true>(T)
  float* s_vrl = s_tri + sweep_floats<true>(T);       // (VRL_ROWS, VRL_CHUNK)
  float* s_tau = s_vrl + VRL_ROWS * VRL_CHUNK;        // (N_WARPS, 3, CB_RAYS)
  float* s_par = s_tau + N_WARPS * L::ROWS * CB_RAYS;  // (N_WARPS, N_SUMS)
  int* s_id = reinterpret_cast<int*>(s_par + N_WARPS * L::N_SUMS);  // (VRL_CHUNK,)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri);
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, reinterpret_cast<float*>(s_id + VRL_CHUNK));

  const int tile = blockIdx.x;
  const int b = tile_rays[(size_t)tile * CB_RAYS + lane];
  const int* ids = table_ids + (size_t)tile_row[tile] * C;
  const float* ws = table_w + (size_t)tile_row[tile] * C;
  Ray ray{};  // padding slots keep ok = false, but join every shuffle
  Cot c{};
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
    for (int ch = 0; ch < 3; ++ch) c.gb[ch] = gbar[(size_t)ch * B + b];
  }
  const auto m = make_medium<false, 0, EXT>(med, nullptr, GridArgs{});
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  float* part = tile_part + (size_t)tile * L::ROWS * C;  // this tile's (3, C)

  for (int c0 = 0; c0 < C; c0 += VRL_CHUNK) {
    __syncthreads();  // the previous piece is consumed (and the block's set-up done)
    const int nc = stage_table_piece(vrls, N, VRL_ROWS, ids, ws, C, c0, s_vrl, s_id);
    __syncthreads();
    for (int cc = warp; cc < nc; cc += N_WARPS) {
      clear_pair_cots<false>(c);
      // VVALID is the same for the whole warp; an invalid column sums 0
      if (ray.ok && s_vrl[VVALID * VRL_CHUNK + cc] > 0.5f) {
        const VrlPair p = pair_at<false>(ray, s_vrl, cc);
        PairUniforms draw{uniforms ? uniforms + ((size_t)b * C + c0 + cc) * n_draws : nullptr,
                          (uint32_t)b, (uint32_t)s_id[cc], seed, make_uint4(0u, 0u, 0u, 0u),
                          -1};
        pair_cots<PHASE, SHORT_VRLS, EXT, MAT>(ray, p, m, draw, svv, svs, occl, inv_vv, inv_vs,
                                               c, &mats);
      }
#pragma unroll
      for (int r = 0; r < L::ROWS; ++r) {
        const float v = warp_sum(c.d_pw[r]);
        if (lane == 0) part[(size_t)r * C + c0 + cc] = v;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < L::ROWS; ++r) s_tau[(warp * L::ROWS + r) * CB_RAYS + lane] = c.d_tau[r];
  __syncthreads();
  if (warp == 0 && b >= 0) {
#pragma unroll
    for (int r = 0; r < L::ROWS; ++r) {
      float v = 0.0f;
      for (int w = 0; w < N_WARPS; ++w) v += s_tau[(w * L::ROWS + r) * CB_RAYS + lane];
      d_ray[(size_t)r * B + b] = v;
    }
  }
  block_par_sums<false, EXT>(c, s_par, par_part, tile);
}

// The grid backward (kernel 11), instantiated for GRID = true: tile
// blockIdx.x, RAY_BLOCK rays of one row, a thread a ray. TRI: the
// trilinear read (UV = 0); MAT: the material form, as kernel 10's.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, bool TRI = false, bool MAT = false>
__global__ void __launch_bounds__(RAY_BLOCK, BWD_MIN_BLOCKS)
    vrl_sum_clustered_bwd_kernel(const float* __restrict__ rays, int B,
                                 const float* __restrict__ vrls, int N,
                                 const float* __restrict__ tris, int T,
                                 const float* __restrict__ med, GridArgs grid,
                                 const int* __restrict__ tile_rays,
                                 const int* __restrict__ tile_row,
                                 const int* __restrict__ table_ids,
                                 const float* __restrict__ table_w, int C,
                                 const float* __restrict__ uniforms, uint32_t seed, int svv,
                                 int svs, const float* __restrict__ gbar,
                                 float* __restrict__ d_ray, float* __restrict__ tile_part,
                                 float* __restrict__ par_part, float* __restrict__ d_density,
                                 const float* __restrict__ mat_table, int M,
                                 const float* __restrict__ rt) {
  using L = Layout<GRID>;
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float smem[];
  float* s_tri = smem;                                   // (T, TRI_COLS)
  float* s_vrl = s_tri + T * TRI_COLS;                   // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;             // grid: (GRID_MED_LEN,)
  float* s_out = s_med + (GRID ? GRID_MED_LEN : 0);      // (N_WARPS, ROWS, VRL_CHUNK)
  float* s_par = s_out + N_WARPS * L::ROWS * VRL_CHUNK;  // (N_WARPS, N_SUMS)
  float* s_eod = s_par + N_WARPS * L::N_SUMS;            // grid: (N_OD, RAY_BLOCK)
  float* s_vod = s_eod + L::N_OD * RAY_BLOCK;            // grid: (N_OD, RAY_BLOCK)
  float* s_etab = s_vod + L::N_OD * RAY_BLOCK;           // grid: (N_OD, RAY_BLOCK)
  int* s_id = reinterpret_cast<int*>(s_etab + L::N_OD * RAY_BLOCK);  // (VRL_CHUNK,)
  const int t = threadIdx.x;
  for (int i = t; i < T * TRI_COLS; i += blockDim.x) s_tri[i] = tris[i];
  stage_medium<GRID>(med, s_med);
  for (int k = 0; k < L::N_OD; ++k) s_eod[k * RAY_BLOCK + t] = 0.0f;  // this thread's column
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, reinterpret_cast<float*>(s_id + VRL_CHUNK));

  const int tile = blockIdx.x;
  const int b = tile_rays[(size_t)tile * RAY_BLOCK + t];
  const int* ids = table_ids + (size_t)tile_row[tile] * C;
  const float* ws = table_w + (size_t)tile_row[tile] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  Cot c{};
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    if constexpr (MAT) attach_mat<GRID>(ray, rays, B, b, mats);
    stage_eod<GRID>(ray, rays, B, b, s_etab);
    for (int ch = 0; ch < 3; ++ch) c.gb[ch] = gbar[(size_t)ch * B + b];
  }
  c.d_eod = s_eod + t;
  c.d_vod = s_vod + t;
  c.d_density = d_density;
  const auto m = make_medium<GRID, UV, false, TRI>(med, s_med, grid);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  float* part = tile_part + (size_t)tile * L::ROWS * C;  // this tile's (ROWS, C)

  for (int c0 = 0; c0 < C; c0 += VRL_CHUNK) {
    __syncthreads();  // the previous piece is consumed (and the block's set-up done)
    const int nc = stage_table_piece(vrls, N, V_ROWS, ids, ws, C, c0, s_vrl, s_id);
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      clear_pair_cots<GRID>(c);
      // VVALID is the same for the whole block; an invalid column sums 0
      if (ray.ok && s_vrl[VVALID * VRL_CHUNK + cc] > 0.5f) {
        const VrlPair p = pair_at<GRID>(ray, s_vrl, cc);
        PairUniforms draw{uniforms ? uniforms + ((size_t)b * C + c0 + cc) * n_draws : nullptr,
                          (uint32_t)b, (uint32_t)s_id[cc], seed, make_uint4(0u, 0u, 0u, 0u),
                          -1};
        pair_cots<PHASE, SHORT_VRLS, false, MAT>(ray, p, m, draw, svv, svs, FlatTris{s_tri, T},
                                                 inv_vv, inv_vs, c, &mats);
      }
      warp_column_sums<GRID>(c, s_out, cc);
    }
    __syncthreads();
    for (int i = t; i < L::ROWS * VRL_CHUNK; i += blockDim.x) {
      const int r = i / VRL_CHUNK, cc = i % VRL_CHUNK;
      if (cc < nc) part[(size_t)r * C + c0 + cc] = block_column_sum<GRID>(s_out, r, cc);
    }
  }

  if (b >= 0) {
#pragma unroll
    for (int r = 0; r < L::ROWS; ++r)
      d_ray[(size_t)r * B + b] = r < 3 ? c.d_tau[r] : c.d_eod[(r - 3) * RAY_BLOCK];
  }
  block_par_sums<GRID>(c, s_par, par_part, tile);
}

// dynamic shared memory of the backward, in bytes, with T triangles:
// Layout's with the triangles (grid) or their plane pack (homogeneous,
// whose per-ray partials take the place of the per-warp column sums),
// the staged table piece's VRL ids, and M material rows (0 but for the
// material forms); ext: the homogeneous pack's extension
template <bool GRID>
size_t clustered_bwd_smem_bytes(int T, int M = 0, bool ext = false) {
  const size_t floats = ext ? Layout<GRID, true>::smem_floats(sweep_floats<!GRID>(T))
                            : Layout<GRID>::smem_floats(sweep_floats<!GRID>(T));
  return floats * sizeof(float) + VRL_CHUNK * sizeof(int) + (size_t)M * MAT_COLS * sizeof(float);
}

// The rays of a tile: CB_RAYS (homogeneous) or RAY_BLOCK (grid).
template <bool GRID>
constexpr int clustered_bwd_tile() {
  return GRID ? RAY_BLOCK : CB_RAYS;
}

// The instantiation that a launch of these arguments takes (the mode:
// MODE_SUM, or homogeneous MODE_NO_REJECT, which the diffuse balance
// forms alone have; ext, tri and mat the forms, as vrl_sum_bwd.cu's
// bwd_kernel picks them; the trilinear and material grid forms at the
// run-time step count).
template <bool GRID, class Phase, class Short, class Uv>
auto clustered_bwd_kernel(Phase, Short, Uv, int mode, bool ext = false, bool tri = false,
                          bool mat = false) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  if constexpr (GRID) {
    if (tri)
      return mat ? &vrl_sum_clustered_bwd_kernel<P, S, true, 0, true, true>
                 : &vrl_sum_clustered_bwd_kernel<P, S, true, 0, true, false>;
    if (mat) return &vrl_sum_clustered_bwd_kernel<P, S, true, 0, false, true>;
    return &vrl_sum_clustered_bwd_kernel<P, S, true, Uv::value>;
  } else if constexpr (P == 2) {
    return mat ? &vrl_sum_clustered_bwd_warps_kernel<2, S, MODE_SUM, true, true>
               : &vrl_sum_clustered_bwd_warps_kernel<2, S, MODE_SUM, true, false>;
  } else {
    if (ext)
      return mat ? &vrl_sum_clustered_bwd_warps_kernel<P, S, MODE_SUM, true, true>
                 : &vrl_sum_clustered_bwd_warps_kernel<P, S, MODE_SUM, true, false>;
    if (mat) return &vrl_sum_clustered_bwd_warps_kernel<P, S, MODE_SUM, false, true>;
    return mode == MODE_NO_REJECT ? &vrl_sum_clustered_bwd_warps_kernel<P, S, MODE_NO_REJECT>
                                  : &vrl_sum_clustered_bwd_warps_kernel<P, S, MODE_SUM>;
  }
}

// d_table[s, r, c] = the sum of row s's tiles' partials in tile order
// (its tiles are row_tiles[s] .. row_tiles[s + 1] - 1), and d_weights[s,
// c] = sum over the power rows of d_table times the VRL's power, 0 for a
// column that is not valid. One thread per (s, c).
template <bool GRID>
__global__ void table_sums(const float* __restrict__ tile_part, const int* __restrict__ row_tiles,
                           int S, int C, const float* __restrict__ vrls, int N,
                           const int* __restrict__ table_ids, const float* __restrict__ table_w,
                           float* __restrict__ d_table, float* __restrict__ d_weights) {
  constexpr int ROWS = Layout<GRID>::ROWS;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * C) return;
  const int s = i / C, c = i % C;
  float dw = 0.0f;
  const int id = table_ids[i];
  const bool valid = column_valid(vrls, N, id, table_w[i]);
  for (int r = 0; r < ROWS; ++r) {
    float v = 0.0f;
    for (int k = row_tiles[s]; k < row_tiles[s + 1]; ++k)
      v += tile_part[((size_t)k * ROWS + r) * C + c];
    d_table[((size_t)s * ROWS + r) * C + c] = v;
    if (r < 3 && valid) dw += v * vrls[(size_t)(VP + r) * N + id];
  }
  d_weights[i] = dw;
}

// d_vrl[r, n] = the sum over the table slots that hold VRL n (slots[k],
// k in slot_start[n] .. slot_start[n + 1] - 1: flat s * C + c, in slot
// order) of w * d_table[s, r, c] for the power rows (r < 3) and d_table[s,
// r, c] for the VOD rows, over the slots of weight > 0 (an invalid VRL's
// d_table is 0). One thread per (r, n).
template <bool GRID>
__global__ void vrl_sums(const float* __restrict__ d_table, const int* __restrict__ slots,
                         const int* __restrict__ slot_start, int N, int C,
                         const float* __restrict__ table_w, float* __restrict__ d_vrl) {
  constexpr int ROWS = Layout<GRID>::ROWS;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ROWS * N) return;
  const int r = i / N, n = i % N;
  float v = 0.0f;
  for (int k = slot_start[n]; k < slot_start[n + 1]; ++k) {
    const int slot = slots[k];
    const float w = table_w[slot];
    if (!(w > 0.0f)) continue;
    v += (r < 3 ? w : 1.0f) * d_table[((size_t)(slot / C) * ROWS + r) * C + slot % C];
  }
  d_vrl[i] = v;
}

// Launches the backward and its ordered reductions on `stream` (after
// zeroing d_ray and, for grid media, d_density; homogeneous: after the
// plane pack of the triangles into `planes`, (T, 4 PLANE_F4) floats of
// scratch, in `mode`, MODE_SUM or MODE_NO_REJECT, the latter for the
// diffuse balance forms only); returns a cudaError_t (0 = launched). The
// form: ext (homogeneous: the pack's extension, the mixture allowed),
// trilinear (grid), M > 0 the material table mat_table, M, rt. Host layout: tile_rays, tile_row
// (group_by_slice, in tiles of clustered_bwd_tile<GRID>() rays),
// row_tiles (S + 1,) each row's first tile, slots and slot_start (N + 1,)
// the table slots by VRL id. Scratch: tile_part (n_tiles, ROWS, C),
// par_part (n_tiles, n_par), d_table (S, ROWS, C). Out: d_ray (ROWS, B) =
// d_tau [, d_eod], d_vrl (ROWS, N) = d_power [, d_vod], d_weights (S, C),
// d_par (n_par,: 8, MED_RHO + 1 with ext, or GRID_MED_LEN) and, for
// grid media, d_density (nz, ny, nx).
template <bool GRID>
int launch_clustered_bwd(const float* rays, int B, const float* vrls, int N, const float* tris,
                         int T, const float* med, GridArgs grid, int trilinear,
                         const float* mat_table, int M, const float* rt, int ext,
                         const int* tile_rays,
                         const int* tile_row, int n_tiles, const int* row_tiles, int S,
                         const int* table_ids, const float* table_w, int C, const int* slots,
                         const int* slot_start, const float* uniforms, unsigned int seed, int svv,
                         int svs, int short_vrls, int phase_kind, const float* gbar,
                         float* planes, int mode, float* tile_part, float* par_part,
                         float* d_table, float* d_ray, float* d_vrl, float* d_weights,
                         float* d_par, float* d_density, void* stream) {
  using L = Layout<GRID>;
  const int n_par = ext ? Layout<false, true>::N_PAR_OUT : L::N_PAR_OUT;
  const bool diffuse = !ext && !trilinear && M == 0;
  if (B <= 0 || N <= 0 || n_tiles <= 0 || S <= 0 || C <= 0 || T < 0 || T > MAX_TRIS ||
      svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1 && !(ext && phase_kind == PHASE_MIXTURE)) ||
      (GRID && ext) || (!GRID && trilinear) || !grid_ok<GRID>(grid) ||
      (GRID && d_density == nullptr) || !mats_ok(mat_table, M, rt) ||
      !mode_ok<false, !GRID>(mode, nullptr) || (mode != MODE_SUM && !diffuse))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<!GRID>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(d_ray, 0, (size_t)L::ROWS * B * sizeof(float), st);
  if (err == cudaSuccess && GRID)
    err = cudaMemsetAsync(d_density, 0, (size_t)grid.nz * grid.ny * grid.nx * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = clustered_bwd_smem_bytes<GRID>(T, M, ext);
  cudaError_t attr = cudaSuccess;
  dispatch<GRID, true>(phase_kind, short_vrls, grid.uv_steps, [&](auto phase, auto short_,
                                                                  auto uv) {
    const auto kernel =
        clustered_bwd_kernel<GRID>(phase, short_, uv, mode, ext, trilinear, M > 0);
    attr = allow_smem(kernel, smem);
    if (attr != cudaSuccess) return;
    if constexpr (GRID)
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, tile_rays,
                                               tile_row, table_ids, table_w, C, uniforms, seed,
                                               svv, svs, gbar, d_ray, tile_part, par_part,
                                               d_density, mat_table, M, rt);
    else
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, tile_rays,
                                               tile_row, table_ids, table_w, C, uniforms, seed,
                                               svv, svs, gbar, d_ray, tile_part, par_part,
                                               mat_table, M, rt);
  });
  if (attr != cudaSuccess) return (int)attr;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_sums<GRID><<<(S * C + 255) / 256, 256, 0, st>>>(tile_part, row_tiles, S, C, vrls, N,
                                                        table_ids, table_w, d_table, d_weights);
  vrl_sums<GRID><<<(L::ROWS * N + 255) / 256, 256, 0, st>>>(d_table, slots, slot_start, N, C,
                                                            table_w, d_vrl);
  reduce_parts_tree<<<n_par, TREE, 0, st>>>(par_part, n_tiles, n_par, d_par);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The rays of a tile of the backward (grid 0: homogeneous, 1: grid
// media), which host_layout groups the rays into.
int alvrl_clustered_bwd_ray_block(int grid) {
  return grid ? clustered_bwd_tile<true>() : clustered_bwd_tile<false>();
}

// The homogeneous clustered backward. The forward's inputs
// (alvrl_vrl_sum_clustered) and gbar (3, B); the material table
// (mat_table, M, rt: null, 0, null for the diffuse form) and ext (the
// medium pack with its extension) as alvrl_vrl_sum_bwd's; the host
// layout and scratch of launch_clustered_bwd (ROWS = 3, n_par = 8 or
// MED_RHO + 1), with `planes` (T, 4 PLANE_F4) float scratch for the
// triangles' plane pack (may be null for T = 0) and the mode (0 the
// backward; 2 the same tiling without the plane pre-reject, whose outputs
// must be the same bit for bit: the diffuse balance forms). Out: d_tau
// (3, B), d_power (3, N), d_weights (S, C), d_par (n_par,). `uniforms`
// may be null (the Philox stream of `seed`, as the forward's).
int alvrl_vrl_sum_clustered_bwd(const float* rays, int B, const float* vrls, int N,
                                const float* tris, int T, const float* med,
                                const float* mat_table, int M, const float* rt, int ext,
                                const int* tile_rays, const int* tile_row, int n_tiles,
                                const int* row_tiles, int S, const int* table_ids,
                                const float* table_w, int C, const int* slots,
                                const int* slot_start, const float* uniforms, unsigned int seed,
                                int svv, int svs, int short_vrls, int phase_kind,
                                const float* gbar, float* planes, int mode, float* tile_part,
                                float* par_part, float* d_table, float* d_tau, float* d_power,
                                float* d_weights, float* d_par, void* stream) {
  return launch_clustered_bwd<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, 0, mat_table, M,
                                     rt, ext, tile_rays, tile_row, n_tiles, row_tiles, S,
                                     table_ids, table_w, C, slots, slot_start, uniforms, seed,
                                     svv, svs, short_vrls, phase_kind, gbar, planes, mode,
                                     tile_part, par_part, d_table, d_tau, d_power, d_weights,
                                     d_par, nullptr, stream);
}

// The grid-medium clustered backward: the grid packs, the supersampled
// density (nz, ny, nx) and the U-V quadrature's step count, as
// alvrl_vrl_sum_hetero_clustered takes them (`trilinear`: the trilinear
// form, on the density itself), the material table as
// alvrl_vrl_sum_clustered_bwd's; ROWS = 3 + NQ + 1, n_par =
// GRID_MED_LEN. Out: d_ray (ROWS, B) = d_tau, d_eod; d_vrl (ROWS, N) =
// d_power, d_vod; d_weights (S, C); d_par (GRID_MED_LEN,); d_density
// (nz, ny, nx), zeroed here first.
int alvrl_vrl_sum_hetero_clustered_bwd(
    const float* rays, int B, const float* vrls, int N, const float* tris, int T,
    const float* med, const float* mat_table, int M, const float* rt, const float* density,
    int nz, int ny, int nx, int uv_steps, int trilinear, const int* tile_rays,
    const int* tile_row, int n_tiles, const int* row_tiles, int S, const int* table_ids,
    const float* table_w, int C, const int* slots, const int* slot_start,
    const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls, int phase_kind,
    const float* gbar, float* tile_part, float* par_part, float* d_table, float* d_ray,
    float* d_vrl, float* d_weights, float* d_par, float* d_density, void* stream) {
  return launch_clustered_bwd<true>(
      rays, B, vrls, N, tris, T, med, GridArgs{density, nz, ny, nx, uv_steps}, trilinear,
      mat_table, M, rt, 0, tile_rays, tile_row, n_tiles, row_tiles, S, table_ids, table_w, C,
      slots, slot_start, uniforms, seed, svv, svs, short_vrls, phase_kind, gbar, nullptr,
      MODE_SUM, tile_part, par_part, d_table, d_ray, d_vrl, d_weights, d_par, d_density, stream);
}

// The backward's blocks resident on one SM, as alvrl_vrl_sum_occupancy
// (the diffuse forms).
int alvrl_vrl_sum_clustered_bwd_occupancy(int grid, int T, int uv_steps, int phase_kind,
                                          int short_vrls, int* blocks) {
  return occupancy(
      grid, T, uv_steps, phase_kind, short_vrls, blocks,
      [](auto g, auto phase, auto short_, auto uv) {
        return clustered_bwd_kernel<decltype(g)::value>(phase, short_, uv, MODE_SUM);
      },
      [](auto g, int n_tris) { return clustered_bwd_smem_bytes<decltype(g)::value>(n_tris); });
}

}  // extern "C"
