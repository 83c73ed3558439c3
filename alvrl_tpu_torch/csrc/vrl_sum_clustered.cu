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
//     would fill it.
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

template <int PHASE, bool SHORT_VRLS, bool GRID>
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
                             int svs, float* __restrict__ out) {
  constexpr int V_ROWS = GRID ? GRID_VRL_ROWS : VRL_ROWS;
  extern __shared__ float smem[];
  float* s_tri = smem;                                             // (T, TRI_COLS)
  float* s_vrl = s_tri + T * TRI_COLS;                             // (V_ROWS, VRL_CHUNK)
  int* s_id = reinterpret_cast<int*>(s_vrl + V_ROWS * VRL_CHUNK);  // (VRL_CHUNK,)
  float* s_med = reinterpret_cast<float*>(s_id + VRL_CHUNK);      // grid: (GRID_MED_LEN,)
  for (int i = threadIdx.x; i < T * TRI_COLS; i += blockDim.x) s_tri[i] = tris[i];
  stage_medium<GRID>(med, s_med);

  const int b = tile_rays[(size_t)blockIdx.x * RAY_BLOCK + threadIdx.x];
  const int* ids = table_ids + (size_t)tile_row[blockIdx.x] * C;
  const float* ws = table_w + (size_t)tile_row[blockIdx.x] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    attach_eod<GRID>(ray, rays, B, b);
  }
  const auto m = make_medium<GRID>(med, s_med, grid);
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
      pair_terms<PHASE, SHORT_VRLS>(ray, p, m, draw, svv, svs, FlatTris{s_tri, T},
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
}

// Launches the clustered sum on `stream`; returns a cudaError_t (0 =
// launched).
template <bool GRID>
int launch_clustered(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                     const float* med, GridArgs grid, const int* tile_rays, const int* tile_row,
                     int n_tiles, const int* table_ids, const float* table_w, int C,
                     const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                     int phase_kind, float* out, void* stream) {
  if (B <= 0 || N <= 0 || n_tiles <= 0 || C <= 0 || T < 0 || T > MAX_TRIS || svv < 0 ||
      svs < 0 || (phase_kind != 0 && phase_kind != 1) || !grid_ok<GRID>(grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(T * TRI_COLS + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
                               (GRID ? GRID_MED_LEN : 0)) *
                          sizeof(float) +
                      VRL_CHUNK * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    vrl_sum_clustered_kernel<decltype(phase)::value, decltype(short_)::value, GRID>
        <<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, tile_rays,
                                           tile_row, table_ids, table_w, C, uniforms, seed, svv,
                                           svs, out);
  });
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
                                 short_vrls, phase_kind, out, stream);
}

// The grid-medium clustered sum: the grid packs (ops/pack.py), the
// supersampled density (nz, ny, nx) and the U-V quadrature's step count;
// the rest as alvrl_vrl_sum_clustered.
int alvrl_vrl_sum_hetero_clustered(const float* rays, int B, const float* vrls, int N,
                                   const float* tris, int T, const float* med,
                                   const float* density, int nz, int ny, int nx, int uv_steps,
                                   const int* tile_rays, const int* tile_row, int n_tiles,
                                   const int* table_ids, const float* table_w, int C,
                                   const float* uniforms, unsigned int seed, int svv, int svs,
                                   int short_vrls, int phase_kind, float* out, void* stream) {
  return launch_clustered<true>(rays, B, vrls, N, tris, T, med,
                                GridArgs{density, nz, ny, nx, uv_steps}, tile_rays, tile_row,
                                n_tiles, table_ids, table_w, C, uniforms, seed, svv, svs,
                                short_vrls, phase_kind, out, stream);
}

}  // extern "C"
