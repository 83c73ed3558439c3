// Clustered VRL sum, hand-written for Hopper (sm_90a).
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
//   * the host groups the rays by table row into tiles (tile_rays: the
//     ray index of each tile slot, -1 for padding; tile_row: each tile's
//     row; group_by_slice at the tile's ray count,
//     alvrl_clustered_ray_block), so that a block shares one row;
//   * the block stages its row's table in VRL_CHUNK pieces, each column
//     gathered from the full VRL pack by id (vrl_common.cuh's
//     stage_table_piece, which the VJP's replay stages through too), and
//     loops over all pieces: there is no cap on the table width and one
//     launch covers it (the TPU kernel took 128 columns per launch);
//   * each ray's (3,) sum is written once to out[:, b], in ray order: no
//     cross-block reduction, no scatter pass, no atomics, and a
//     deterministic result. Rays in no tile are not written (the wrapper
//     zeroes out);
//   * both media sweep a plane pack, which the C entry makes in front of
//     the launch (vrl_sum.cu:alvrl_plane_pack) and the block stages in
//     shared memory, with kernel 1's plane pre-reject (vrl_common.cuh
//     PlaneTris): a triangle's Wald test is skipped where the segment's
//     two tested ends lie on one side of its plane by a proven margin.
//     The checking instantiation (MODE_CHECK) decides by the Wald test
//     alone and counts, as kernel 1's does.
// The two media take two tilings:
//   * homogeneous (kernel 2, vrl_sum_clustered_warps_kernel): config 2's
//     100 rows average about 164 rays, so tiles of RAY_BLOCK rays were
//     164 blocks on 132 SMs, a fifth of their lanes padding. A tile is
//     C_RAYS = 32 rays, a warp's lanes over them, and the block's N_WARPS
//     warps split each staged piece's columns (column c to warp c %
//     N_WARPS), as kernel 10 (vrl_sum_clustered_bwd.cu) does: 542 tiles
//     at config 2, 5.5 % padding. Each lane sums its ray over its warp's
//     columns; the block adds the warps' sums in warp order through
//     shared memory. MODE_NO_REJECT is the same tiling with the plane
//     pack's flat sweep, whose output must be the same bit for bit;
//   * grid (kernel 4, vrl_sum_clustered_kernel, GRID = true): tiles of
//     RAY_BLOCK rays, a thread a ray walking the row's columns (2,096
//     blocks at config 4 fill the card), with kernel 3's and kernel 11's
//     grid items: the U-V quadrature's step count a template argument
//     (UV_STEPS, every caller's; UV = 0 the generic run-time count), so
//     the 4-step instantiation has its steps' points as constants and
//     sends their density loads together; the ray's eye-OD table staged
//     per thread in shared memory (stage_eod; padding slots stage
//     nothing, but join every barrier), since the rays of a tile come
//     scattered through tile_rays and each sample's two table reads
//     would otherwise gather at a stride of B floats. Config 4's 12
//     walls never block a segment inside the box, and the pre-reject
//     skips most of their Wald tests.
//
// Random numbers: Philox4x32-10 with key (seed, 0) and counter (b, VRL
// id, call, 0), b the ray's index in the ray pack (the pixel in frame
// order), in the draw order of vrl_sum.cu: the stream does not depend on
// the grouping or the table layout, and with a table that holds every VRL
// at weight 1 the result is vrl_sum's (up to f32 summation order).
// `uniforms`, when given, is read instead, as (B, C, 2 * svv + svs)
// float32 indexed by ray and table column.
// Kernel 2 also has a material instantiation (MAT) for glossy and layered
// surfaces at the eye hit, as vrl_sum.cu's kernel 1 (vrl_common.cuh
// eval_smooth); its lanes are rays, which may diverge in the eval. So has
// kernel 4 (MAT, nearest or TRI, at the run-time step count; ROADMAP C21:
// the JAX package's Pallas kernel evaluates no BSDF).
// Precise math functions throughout (no --use_fast_math).

#include "vrl_sum_clustered.cuh"

namespace {

// rays of a homogeneous tile: one warp's lanes (module comment)
constexpr int C_RAYS = 32;
static_assert(RAY_BLOCK == N_WARPS * C_RAYS, "a warp a column");

// Kernel 2: tile blockIdx.x, C_RAYS rays of one row (lane = ray), the
// warps over the row's columns; tris: the triangles' plane pack, swept
// by PlaneTris<MODE> (MODE_SUM; MODE_CHECK, which counts; MODE_NO_REJECT).
// MAT: the material instantiation (vrl_sum.cu's vrl_sum_plane_kernel),
// its M material rows staged after the warps' sums and the ids.
template <int PHASE, bool SHORT_VRLS, int MODE, bool MAT>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_clustered_warps_kernel(const float* __restrict__ rays, int B,
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
  float* s_mat = reinterpret_cast<float*>(s_id + VRL_CHUNK);  // MAT: (M, MAT_COLS)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const auto occl = stage_sweep<true, MODE>(tris, T, s_tri, &cnt);
  Mats mats{};
  if constexpr (MAT) {
    mats = stage_mats(mat_table, M, rt, s_mat);
    __syncthreads();  // attach_mat reads the rows
  }

  const int tile = blockIdx.x;
  const int b = tile_rays[(size_t)tile * C_RAYS + lane];
  const int* ids = table_ids + (size_t)tile_row[tile] * C;
  const float* ws = table_w + (size_t)tile_row[tile] * C;
  Ray ray{};  // padding slots keep ok = false, but join every barrier
  if (b >= 0) {
    ray = load_ray(rays, B, b);
    if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
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
      pair_terms<PHASE, SHORT_VRLS, MAT>(
          ray, p, m, draw, svv, svs, occl,
          [&](int family, const float* t) {
            const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
          },
          &mats);
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

// The instantiation that a launch of these arguments takes (the mode:
// MODE_SUM or MODE_CHECK, or homogeneous MODE_NO_REJECT; Tri: the grid
// kernel's trilinear form; MAT: the material form, the grid one at the
// run-time step count whatever Uv).
template <bool GRID, bool MAT = false, class Phase, class Short, class Uv,
          class Tri = std::false_type>
auto clustered_kernel(Phase, Short, Uv, int mode, Tri = {}) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  if constexpr (GRID) {
    constexpr bool T = Tri::value;
    constexpr int UV = MAT ? 0 : Uv::value;
    return mode == MODE_CHECK ? &vrl_sum_clustered_kernel<P, S, true, UV, MODE_CHECK, T, MAT>
                              : &vrl_sum_clustered_kernel<P, S, true, UV, MODE_SUM, T, MAT>;
  } else {
    using K = decltype(&vrl_sum_clustered_warps_kernel<P, S, MODE_SUM, MAT>);
    if (mode == MODE_CHECK) return K(&vrl_sum_clustered_warps_kernel<P, S, MODE_CHECK, MAT>);
    if (mode == MODE_NO_REJECT) {
      if constexpr (P == 2)
        return K(nullptr);  // the mixture has no timing form
      else
        return K(&vrl_sum_clustered_warps_kernel<P, S, MODE_NO_REJECT, MAT>);
    }
    return K(&vrl_sum_clustered_warps_kernel<P, S, MODE_SUM, MAT>);
  }
}

// The rays of a tile: C_RAYS (homogeneous) or RAY_BLOCK (grid).
template <bool GRID>
constexpr int clustered_tile() {
  return GRID ? RAY_BLOCK : C_RAYS;
}

// dynamic shared memory of the sum, in bytes, with T triangles: the
// plane pack, the staged table piece and its VRL ids, and the grid's
// medium and eye-OD tables or the homogeneous warps' per-ray sums
template <bool GRID>
size_t clustered_smem_bytes(int T, int M = 0) {
  return (sweep_floats<true>(T) + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
          (GRID ? GRID_MED_LEN + (NQ + 1) * RAY_BLOCK : N_WARPS * 3 * C_RAYS) +
          (size_t)M * MAT_COLS) *
             sizeof(float) +
         VRL_CHUNK * sizeof(int);
}

// Launches the clustered sum on `stream` after the plane pack of the T
// triangles into `planes` ((T, 4 PLANE_F4) floats of scratch), in `mode`
// (MODE_CHECK adds its counts to counts[N_CHECK]; homogeneous
// MODE_NO_REJECT sweeps without the pre-reject); tile_rays holds
// clustered_tile<GRID>() slots a tile. Returns a cudaError_t (0 =
// launched).
template <bool GRID>
int launch_clustered(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                     const float* med, GridArgs grid, int trilinear, const float* mat_table, int M,
                     const float* rt, const int* tile_rays, const int* tile_row, int n_tiles,
                     const int* table_ids, const float* table_w, int C, const float* uniforms,
                     unsigned int seed, int svv, int svs, int short_vrls, int phase_kind,
                     float* planes, int mode, unsigned long long* counts, float* out,
                     void* stream) {
  if (B <= 0 || N <= 0 || n_tiles <= 0 || C <= 0 || T < 0 || T > MAX_TRIS || svv < 0 ||
      svs < 0 || !grid_ok<GRID>(grid) || !mode_ok<true, !GRID>(mode, counts) ||
      !mats_ok(mat_table, M, rt) ||
      (phase_kind == PHASE_MIXTURE && mode == MODE_NO_REJECT))
    return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = clustered_smem_bytes<GRID>(T, M);
  cudaError_t err = cudaSuccess;
  const int d = dispatch_read<GRID, true>(phase_kind, short_vrls, grid.uv_steps, trilinear,
                                          [&](auto phase, auto short_, auto uv, auto tri) {
    const auto kernel = M > 0 ? clustered_kernel<GRID, true>(phase, short_, uv, mode, tri)
                              : clustered_kernel<GRID, false>(phase, short_, uv, mode, tri);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return;
    if constexpr (GRID)
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, tile_rays,
                                               tile_row, table_ids, table_w, C, uniforms, seed,
                                               svv, svs, out, counts, mat_table, M, rt);
    else
      kernel<<<n_tiles, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, mat_table, M, rt,
                                               tile_rays, tile_row, table_ids, table_w, C,
                                               uniforms, seed, svv, svs, out, counts);
  });
  if (d != 0) return d;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The rays of a tile of the clustered sum (grid 0: homogeneous, 1: grid
// media), which the wrapper groups the rays into (group_by_slice).
int alvrl_clustered_ray_block(int grid) {
  return grid ? clustered_tile<true>() : clustered_tile<false>();
}

// The homogeneous clustered sum. tile_rays (n_tiles *
// alvrl_clustered_ray_block(0),) int32 ray indices or -1, tile_row
// (n_tiles,) int32 table rows, table_ids / table_w (S, C); `planes` (T,
// 4 PLANE_F4) float scratch for the triangles' plane pack (may be null
// for T = 0); mode 0 the sum, 1 the checking instantiation (counts:
// N_CHECK totals, zeroed by the caller, as alvrl_vrl_sum's), 2 the sum
// without the plane pre-reject (its output must be the same bit for
// bit); `out` is (3, B), written only at the rays of the tiles.
// `uniforms` may be null (Philox stream from `seed`).
// mat_table, M and rt: the material table of the material instantiation,
// as alvrl_vrl_sum's (null, 0, null: the diffuse sum); tex 1: its textured
// form (vrl_tex.cuh), as alvrl_vrl_sum's.
int alvrl_vrl_sum_clustered(const float* rays, int B, const float* vrls, int N,
                            const float* tris, int T, const float* med, const float* mat_table,
                            int M, const float* rt, int tex, const int* tile_rays,
                            const int* tile_row, int n_tiles, const int* table_ids,
                            const float* table_w, int C, const float* uniforms, unsigned int seed,
                            int svv, int svs, int short_vrls, int phase_kind, float* planes,
                            int mode, unsigned long long* counts, float* out, void* stream) {
  if (tex)
    return alvrl_vrl_sum_clustered_tex(rays, B, vrls, N, tris, T, med, mat_table, M, rt,
                                       tile_rays, tile_row, n_tiles, table_ids, table_w, C,
                                       uniforms, seed, svv, svs, short_vrls, phase_kind, planes,
                                       mode, counts, out, stream);
  return launch_clustered<false>(rays, B, vrls, N, tris, T, med, GridArgs{}, 0, mat_table, M, rt,
                                 tile_rays, tile_row, n_tiles, table_ids, table_w, C, uniforms,
                                 seed, svv, svs, short_vrls, phase_kind, planes, mode, counts, out,
                                 stream);
}

// The grid-medium clustered sum: the grid packs (ops/pack.py), the
// supersampled density (nz, ny, nx) and the U-V quadrature's step count
// (trilinear 1: the trilinear form, on the trilinear medium pack and the
// density itself, each extent at least 2); tiles of
// alvrl_clustered_ray_block(1) slots; mode 0 or 1; mat_table, M and rt:
// the material table of the material form (either read, the run-time
// step count; rays with the GRID_MATID row), or null, 0, null; tex 1
// (with a table): the textured forms (vrl_sum_clustered_grid_tex.cu), on
// the grid textured pack; the rest as alvrl_vrl_sum_clustered.
int alvrl_vrl_sum_hetero_clustered(const float* rays, int B, const float* vrls, int N,
                                   const float* tris, int T, const float* med,
                                   const float* mat_table, int M, const float* rt, int tex,
                                   const float* density, int nz, int ny, int nx, int uv_steps,
                                   int trilinear, const int* tile_rays, const int* tile_row,
                                   int n_tiles, const int* table_ids, const float* table_w, int C,
                                   const float* uniforms, unsigned int seed, int svv, int svs,
                                   int short_vrls, int phase_kind, float* planes, int mode,
                                   unsigned long long* counts, float* out, void* stream) {
  if (tex)
    return alvrl_vrl_sum_hetero_clustered_tex(
        rays, B, vrls, N, tris, T, med, mat_table, M, rt, density, nz, ny, nx, uv_steps,
        trilinear, tile_rays, tile_row, n_tiles, table_ids, table_w, C, uniforms, seed, svv, svs,
        short_vrls, phase_kind, planes, mode, counts, out, stream);
  if (trilinear && (nz < 2 || ny < 2 || nx < 2)) return (int)cudaErrorInvalidValue;
  return launch_clustered<true>(rays, B, vrls, N, tris, T, med,
                                GridArgs{density, nz, ny, nx, uv_steps}, trilinear, mat_table, M,
                                rt, tile_rays, tile_row, n_tiles, table_ids, table_w, C, uniforms,
                                seed, svv, svs, short_vrls, phase_kind, planes, mode, counts, out,
                                stream);
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
