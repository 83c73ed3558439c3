// Clustered VRL sum, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_clustered (its body
// `_kernel` with clustered=True, hetero=False; entry point
// alvrl_vrl_sum_clustered) and, for grid media,
// vrl_sum_pallas_hetero_clustered (hetero=True;
// alvrl_vrl_sum_hetero_clustered: each column's VRL-OD rows are gathered
// by id with its other rows, and the grid estimator is vrl_sum.cu's).
// Each eye ray b sums the
// estimator over the representatives of its slice only: row r of a table
// of VRL ids (S, C) int32 and weights (S, C) float32, the weight
// multiplied into the VRL's power before anything else and a column
// valid where the VRL is valid and its weight is > 0 (an id outside
// [0, N) counts as invalid). Out (3, B) float32 in ray order, not
// normalised by the particle count. Plain PyTorch twins:
// ops/vrl_sum_clustered.py:vrl_sum_clustered_reference and
// vrl_sum_hetero_clustered_reference. The estimator is the one of
// vrl_sum.cu, from vrl_common.cuh (pair_terms, templated on the medium).
//
// What bounds it on the H100: fp32 ALU and SFU throughput, as vrl_sum
// (per pair-sample about 150 float32 operations and 20 special-function
// operations, and 59 operations per triangle of its shadow sweep, as
// chip_smoke.py's OPS counts them; a grid sample about 100 and 4 more,
// GRID_OPS), on an input under 1 MB (the 3.4 MB config-4 density grid
// aside, which stays in L2).
// A clustered pass has ~10 representatives per ray (config 2), about 50x
// fewer pairs than the unclustered sum. The design:
//   * the host groups the rays by table row into tiles of RAY_BLOCK
//     (tile_rays: the ray index of each tile slot, -1 for padding;
//     tile_row: each tile's row), so that a block shares one row;
//   * the block stages the triangles, then its row's table in VRL_CHUNK
//     pieces, each column gathered from the full VRL pack by id
//     (vrl_common.cuh's stage_table_piece, which the VJP's replay stages
//     through too), and loops over all pieces: there is no cap on the
//     table width and one launch covers it (the TPU kernel took 128
//     columns per launch);
//   * each thread owns one ray and writes its (3,) sum to out[:, b]
//     directly, in ray order: no cross-block reduction, no scatter pass,
//     and a deterministic result. Rays in no tile are not written (the
//     wrapper zeroes out);
//   * at config 2 the grid is ~164 blocks of 128 threads on 132 SMs, so
//     the card is under-filled; splitting a row's table across blocks
//     would fill it;
//   * the grid instantiations (kernel 4) carry kernel 3's and kernel 11's
//     grid items: the U-V quadrature's step count a template argument
//     (UV_STEPS, every caller's; UV = 0 the generic run-time count), so
//     the 4-step instantiation has its steps' points as constants and
//     sends their density loads together; the ray's eye-OD table staged
//     per thread in shared memory (stage_eod; padding slots stage
//     nothing, but join every barrier), since the rays of a tile come
//     scattered through tile_rays and each sample's two table reads
//     would otherwise gather at a stride of B floats; and kernel 1's
//     plane pre-reject (vrl_common.cuh PlaneTris) over a plane pack
//     that the C entry makes in front of the launch
//     (vrl_sum.cu:alvrl_plane_pack) and the block stages in shared
//     memory: config 4's 12 walls never block a segment inside the box,
//     and the pre-reject skips their Wald tests where a segment's two
//     tested ends lie on one side by its proven margin. Its checking
//     instantiation (MODE_CHECK) decides by the Wald test alone and
//     counts, as kernel 1's does. The homogeneous instantiations (kernel
//     2) keep the flat sweep (FlatTris) and the run-time step count.
//
// Random numbers: Philox4x32-10 with key (seed, 0) and counter (b, VRL
// id, call, 0), b the ray's index in the ray pack (the pixel in frame
// order), in the draw order of vrl_sum.cu: the stream does not depend on
// the grouping or the table layout, and with a table that holds every VRL
// at weight 1 the result is vrl_sum's (up to f32 summation order).
// `uniforms`, when given, is read instead, as (B, C, 2 * svv + svs)
// float32 indexed by ray and table column.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_common.cuh"

namespace {

// Kernel 2 (GRID = false) and kernel 4 (GRID = true; UV steps, or 0 for
// the run-time count; MODE_SUM or MODE_CHECK): the sum of one tile.
// tris: the triangles, TRI_COLS floats each (homogeneous), or their
// plane pack (grid media), as sweep_floats<GRID>.
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, int MODE>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_clustered_kernel(const float* __restrict__ rays, int B,
                             const float* __restrict__ vrls, int N,
                             const float* __restrict__ tris, int T,
                             const float* __restrict__ med, GridArgs grid,
                             const int* __restrict__ tile_rays,
                             const int* __restrict__ tile_row,
                             const int* __restrict__ table_ids,
                             const float* __restrict__ table_w, int C,
                             const float* __restrict__ uniforms, uint32_t seed, int svv,
                             int svs, float* __restrict__ out,
                             unsigned long long* __restrict__ counts) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float4 smem4[];  // float4: the plane pack's alignment
  float* s_tri = reinterpret_cast<float*>(smem4);     // sweep_floats<GRID>(T)
  float* s_vrl = s_tri + sweep_floats<GRID>(T);       // (V_ROWS, VRL_CHUNK)
  float* s_med = s_vrl + V_ROWS * VRL_CHUNK;          // grid: (GRID_MED_LEN,)
  float* s_etab = s_med + (GRID ? GRID_MED_LEN : 0);  // grid: (NQ + 1, RAY_BLOCK)
  // (VRL_CHUNK,) ids of the staged table piece
  int* s_id = reinterpret_cast<int*>(s_etab + (GRID ? (NQ + 1) * RAY_BLOCK : 0));
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<GRID, MODE>(tris, T, s_tri, &cnt);
  stage_medium<GRID>(med, s_med);

  const int b = tile_rays[(size_t)blockIdx.x * RAY_BLOCK + threadIdx.x];
  const int* ids = table_ids + (size_t)tile_row[blockIdx.x] * C;
  const float* ws = table_w + (size_t)tile_row[blockIdx.x] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    stage_eod<GRID>(ray, rays, B, b, s_etab);  // this thread's column only
  }
  const auto m = make_medium<GRID, UV>(med, s_med, grid);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < C; c0 += VRL_CHUNK) {
    __syncthreads();  // the previous piece is consumed (and the triangles staged)
    const int nc = stage_table_piece(vrls, N, V_ROWS, ids, ws, C, c0, s_vrl, s_id);
    __syncthreads();
    for (int c = 0; ray.ok && c < nc; ++c) {
      if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
      const VrlPair p = pair_at<GRID>(ray, s_vrl, c);
      PairUniforms draw{uniforms ? uniforms + ((size_t)b * C + c0 + c) * n_draws : nullptr,
                        (uint32_t)b, (uint32_t)s_id[c], seed, make_uint4(0u, 0u, 0u, 0u), -1};
      pair_terms<PHASE, SHORT_VRLS>(ray, p, m, draw, svv, svs, occl,
                                    [&](int family, const float* t) {
                                      const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
                                      for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
                                    });
    }
  }
  if (b >= 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[(size_t)ch * B + b] = acc[ch];
  }
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

using ClusteredKernel = void (*)(const float*, int, const float*, int, const float*, int,
                                 const float*, GridArgs, const int*, const int*, const int*,
                                 const float*, int, const float*, uint32_t, int, int, float*,
                                 unsigned long long*);

// The instantiation that a launch of these arguments takes.
template <bool GRID, class Phase, class Short, class Uv>
ClusteredKernel clustered_kernel(Phase, Short, Uv, int mode) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  if constexpr (GRID)
    if (mode == MODE_CHECK) return &vrl_sum_clustered_kernel<P, S, true, Uv::value, MODE_CHECK>;
  return &vrl_sum_clustered_kernel<P, S, GRID, Uv::value, MODE_SUM>;
}

// dynamic shared memory of the sum, in bytes, with T triangles
template <bool GRID>
size_t clustered_smem_bytes(int T) {
  return (sweep_floats<GRID>(T) + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
          (GRID ? GRID_MED_LEN + (NQ + 1) * RAY_BLOCK : 0)) *
             sizeof(float) +
         VRL_CHUNK * sizeof(int);
}

// Launches the clustered sum on `stream`, in a grid medium after the
// plane pack of the T triangles into `planes` ((T, 4 PLANE_F4) floats of
// scratch) and in `mode` (MODE_CHECK adds its counts to
// counts[N_CHECK]); returns a cudaError_t (0 = launched).
template <bool GRID>
int launch_clustered(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                     const float* med, GridArgs grid, const int* tile_rays, const int* tile_row,
                     int n_tiles, const int* table_ids, const float* table_w, int C,
                     const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                     int phase_kind, float* planes, int mode, unsigned long long* counts,
                     float* out, void* stream) {
  if (B <= 0 || N <= 0 || n_tiles <= 0 || C <= 0 || T < 0 || T > MAX_TRIS || svv < 0 ||
      svs < 0 || (phase_kind != 0 && phase_kind != 1) || !grid_ok<GRID>(grid) ||
      !mode_ok<GRID>(mode, counts))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<GRID>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = clustered_smem_bytes<GRID>(T);
  cudaError_t err = cudaSuccess;
  dispatch<GRID>(phase_kind, short_vrls, grid.uv_steps, [&](auto phase, auto short_, auto uv) {
    const ClusteredKernel kernel = clustered_kernel<GRID>(phase, short_, uv, mode);
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, tile_rays,
                                               tile_row, table_ids, table_w, C, uniforms, seed,
                                               svv, svs, out, counts);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The homogeneous clustered sum. tile_rays (n_tiles * RAY_BLOCK,) int32
// ray indices or -1, tile_row (n_tiles,) int32 table rows, table_ids /
// table_w (S, C); `out` is (3, B), written only at the rays of the
// tiles. `uniforms` may be null (Philox stream from `seed`).
int alvrl_vrl_sum_clustered(const float* rays, int B, const float* vrls, int N,
                            const float* tris, int T, const float* med, const int* tile_rays,
                            const int* tile_row, int n_tiles, const int* table_ids,
                            const float* table_w, int C, const float* uniforms, unsigned int seed,
                            int svv, int svs, int short_vrls, int phase_kind, float* out,
                            void* stream) {
  return launch_clustered<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, tile_rays, tile_row,
                                 n_tiles, table_ids, table_w, C, uniforms, seed, svv, svs,
                                 short_vrls, phase_kind, nullptr, MODE_SUM, nullptr, out, stream);
}

// The grid-medium clustered sum: the grid packs (ops/pack.py), the
// supersampled density (nz, ny, nx) and the U-V quadrature's step count;
// `planes` (T, 4 PLANE_F4) float scratch for the triangles' plane pack
// (may be null for T = 0); mode 0 the sum, 1 the checking instantiation
// (counts: N_CHECK totals, zeroed by the caller, as alvrl_vrl_sum's);
// the rest as alvrl_vrl_sum_clustered.
int alvrl_vrl_sum_hetero_clustered(const float* rays, int B, const float* vrls, int N,
                                   const float* tris, int T, const float* med,
                                   const float* density, int nz, int ny, int nx, int uv_steps,
                                   const int* tile_rays, const int* tile_row, int n_tiles,
                                   const int* table_ids, const float* table_w, int C,
                                   const float* uniforms, unsigned int seed, int svv, int svs,
                                   int short_vrls, int phase_kind, float* planes, int mode,
                                   unsigned long long* counts, float* out, void* stream) {
  return launch_clustered<true>(rays, B, vrls, N, tris, T, med,
                                GridArgs{density, nz, ny, nx, uv_steps}, tile_rays, tile_row,
                                n_tiles, table_ids, table_w, C, uniforms, seed, svv, svs,
                                short_vrls, phase_kind, planes, mode, counts, out, stream);
}

// The clustered sum's blocks resident on one SM, as alvrl_vrl_sum_occupancy.
int alvrl_vrl_sum_clustered_occupancy(int grid, int T, int uv_steps, int phase_kind,
                                      int short_vrls, int* blocks) {
  return occupancy(
      grid, T, uv_steps, phase_kind, short_vrls, blocks,
      [](auto g, auto phase, auto short_, auto uv) {
        return clustered_kernel<decltype(g)::value>(phase, short_, uv, MODE_SUM);
      },
      [](auto g, int n_tris) { return clustered_smem_bytes<decltype(g)::value>(n_tris); });
}

}  // extern "C"
