// VRL x eye-ray sum, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas (its body `_kernel`
// with hetero=False, clustered=False, r_mode=False and the triangle
// sweep; entry point alvrl_vrl_sum) and, for grid media,
// vrl_sum_pallas_hetero (hetero=True; entry point alvrl_vrl_sum_hetero).
// For each eye ray b it returns the sum over the valid VRLs n of the
// vol-vol and vol-surf estimators, (3, B) float32, not normalised by the
// particle count. Plain PyTorch twins: ops/vrl_sum.py:vrl_sum_reference
// and vrl_sum_hetero_reference. The samplers, shared with the VJP
// (vrl_sum_bwd.cu), and both media are in vrl_common.cuh; the medium is
// the kernel's third template parameter. Kernel 1 reads the medium pack
// with its extension (the strategy's rate, a mixture's components: the
// wrapper pads a plain pack with rate 0 and no components), and has a
// PHASE = 2 form for the mixture phase (phase kind 4; every mode but
// the timing one, diffuse and material), which the XLA route of the
// JAX package evaluates and its Pallas kernel does not (ROADMAP C16).
// The grid sum has a trilinear form (vrl_sum_tri_kernel, a medium of
// fast_tau False: the trilinear medium pack and the density itself, 8
// corner reads and 7 lerps a lookup, vrl_common.cuh GridMedium<0,
// true>, at the run-time step count), which the XLA route computes and
// the Pallas kernel does not (ROADMAP C20); its plain version is
// vrl_sum_hetero_reference with the trilinear read.
//
// What bounds it on the H100: fp32 ALU and SFU instruction throughput. One
// pair-sample costs about 150 float32 operations and 20 special-function
// operations (sqrt, division, exp; beside sinh/asinh, atan, tan), and 59
// operations per triangle of its shadow sweep, as chip_smoke.py's OPS
// counts them, against an input of under 1 MB, so neither device memory
// nor tensor cores matter. A grid-medium sample adds about 100 float32
// and 4 special-function operations at 4 U-V steps (the density reads,
// the two OD-table interpolations, the quadrature; GRID_OPS there) and
// reads the 3.4 MB config-4 density grid, which stays in L2: still bound
// by operations, as the ablations of scripts/time_kernels.py
// --grid-split show at config 4 (the density gathers, all sent to one
// address, save about 1 % of the time, the shadow sweep's removal about
// 40 %; the rest is the samplers' precise special functions and the
// estimator). Tensor cores, wgmma and TMA do not apply: there is no
// matrix product or tiled stream, only per-pair scalar and special-
// function math and gathers. The design keeps the working set on chip
// and spreads the pairs over enough threads:
//   * grid = ray tiles (RAY_BLOCK threads, one ray each) x VRL chunks of
//     VRL_CHUNK; one thread per ray alone would fill about a sixteenth
//     of the card at 16k rays, so the VRL axis is split as well;
//   * each block stages its VRL chunk in shared memory; every thread
//     then reads the same triangle at the same time, a broadcast: the
//     grid kernels stage all T triangles in shared memory; kernel 1 (the
//     homogeneous sum, vrl_sum_plane_kernel) reads them from a plane pack
//     (plane_pack_kernel, made in front of it on the same stream) in
//     shared memory (the constant bank measured 6-7 % slower on an
//     H100: the Wald stage reads a different triangle in each lane,
//     which the constant cache serves one address at a time; PERF.md);
//   * each thread loops over its chunk in a fixed order; partial sums go
//     to (n_chunks, 3, B) scratch and a second kernel adds the chunks in
//     a fixed order, so the result is deterministic;
//   * grid media: the block also stages its chunk's VRL-OD rows (17 x
//     VRL_CHUNK floats) and the medium pack in shared memory, and each
//     thread its ray's eye-OD rows (a column of 17 floats that only it
//     reads, so a sample's two table reads stay on chip); the density
//     grid is read from device memory (read-only path; 3.4 MB at config
//     4, held in L2), by nearest lookup: no CP factors (the TPU kernel's
//     lane gathers worked around Mosaic's lack of general gathers);
//   * the U-V quadrature's step count is a template argument (UV): every
//     caller passes 4 (VRLConfig.uv_tau_steps), whose instantiation has
//     the steps' points as constants and sends their four density
//     loads together; any other count takes the generic instantiation
//     (UV = 0, the run-time count). The 4-step instantiation is bounded
//     to 96 registers (__launch_bounds__(128, 5): five blocks, 20 warps,
//     an SM, for latency hiding; 8 B of spill), which measured 5 %
//     faster than four blocks at its natural 110-115 registers, and
//     faster than six (PERF.md);
//   * shadow segments use the division-free Wald test, one sweep over
//     the triangles per sample segment, with an early exit on the first
//     blocker; kernel 1's sweep (vrl_common.cuh PlaneTris) first tests
//     each triangle's plane against the segment's two tested ends and
//     skips the Wald test where both lie on one side by a proven margin
//     (84 % of config 1's tests), deciding every segment as the Wald
//     test alone does, which its checking instantiation counts; the
//     pre-reject runs over 32 triangles at a time into a mask with no
//     branch, and a lane then runs the Wald tests of its own kept
//     triangles only (a plane record shared by a quad's two halves, or a
//     list of plane records, measured slower on an H100: PERF.md);
//   * random numbers come from a counter-based Philox4x32-10, so the
//     stream does not depend on the tiling: key (seed, 0), counter
//     (b, n, j, 0), draw d of a pair is word d % 4 of call j = d / 4,
//     u = (bits >> 8) * 2^-24. Draw order per pair: the vol-vol samples'
//     (V, U) draws, then the vol-surf samples' draws. `uniforms`, when
//     given, is read instead, as (B, N, 2 * svv + svs) float32.
//   * glossy and layered surfaces: kernel 1's material instantiation
//     (MAT, launched with a material table) evaluates the eye hit's
//     smooth BSDF at each vol-surf sample (vrl_common.cuh eval_smooth:
//     the eleven smooth kinds, one nesting level, the rough coats'
//     transmittance tables read through the read-only path) in place of
//     the diffuse albedo cos / pi, its M table rows staged in shared
//     memory after the VRL chunk; the diffuse instantiation is the
//     unchanged code. Lanes are rays, so a warp's rays may hit different
//     kinds and diverge in the eval. The grid sum has material forms too
//     (vrl_sum_mat_kernel, nearest and trilinear, at the run-time step
//     count and the plain launch bound: the grid vol_surf_term with
//     eval_smooth, the table after the eye-OD tables, the id from the
//     grid ray pack's GRID_MATID row), which the JAX package's XLA route
//     computes and its Pallas kernel does not (ROADMAP C21); their plain
//     version is vrl_sum_hetero_reference with `materials`.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_sum.cuh"

namespace {

// The grid kernel: the run-time-step (UV = 0) instantiations, under the
// launch bound every kernel of the port has...
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                   const float* __restrict__ tris, int T, const float* __restrict__ med,
                   GridArgs grid, const float* __restrict__ uniforms, uint32_t seed, int svv,
                   int svs, float* __restrict__ partial) {
  sum_block<PHASE, SHORT_VRLS, GRID, UV>(rays, B, vrls, N, tris, T, med, grid, uniforms, seed, svv,
                                         svs, partial);
}

// ...the trilinear form (a medium of fast_tau False: vrl_common.cuh
// GridMedium<0, true>), at the run-time step count and the same launch
// bound...
template <int PHASE, bool SHORT_VRLS>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_tri_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float* __restrict__ tris, int T,
                       const float* __restrict__ med, GridArgs grid,
                       const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                       float* __restrict__ partial) {
  sum_block<PHASE, SHORT_VRLS, true, 0, true>(rays, B, vrls, N, tris, T, med, grid, uniforms, seed,
                                              svv, svs, partial);
}

// ...the material forms (glossy and layered surfaces in a grid medium:
// the eye hit's smooth BSDF, vrl_common.cuh eval_smooth), nearest or TRI,
// at the run-time step count and the same launch bound...
template <int PHASE, bool SHORT_VRLS, bool TRI>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_mat_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float* __restrict__ tris, int T,
                       const float* __restrict__ med, GridArgs grid,
                       const float* __restrict__ mat_table, int M, const float* __restrict__ rt,
                       const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                       float* __restrict__ partial) {
  sum_block<PHASE, SHORT_VRLS, true, 0, TRI, true>(rays, B, vrls, N, tris, T, med, grid, uniforms,
                                                   seed, svv, svs, partial, mat_table, M, rt);
}

// ...and the grid instantiation compiled for UV steps, also bounded to
// MIN_BLOCKS resident blocks an SM (GRID_MIN_BLOCKS: 96 registers, 20
// warps), which measured faster than its natural 110-115 registers at 4
// blocks. A separate template, so that the others keep the registers
// the compiler gives them without a minimum.
constexpr int GRID_MIN_BLOCKS = 5;

template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, int MIN_BLOCKS>
__global__ void __launch_bounds__(RAY_BLOCK, MIN_BLOCKS)
    vrl_sum_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                   const float* __restrict__ tris, int T, const float* __restrict__ med,
                   GridArgs grid, const float* __restrict__ uniforms, uint32_t seed, int svv,
                   int svs, float* __restrict__ partial) {
  sum_block<PHASE, SHORT_VRLS, GRID, UV>(rays, B, vrls, N, tris, T, med, grid, uniforms, seed, svv,
                                         svs, partial);
}

// The kernel that a launch of these template arguments takes (TRI: the
// trilinear form, grid only).
template <int PHASE, bool SHORT_VRLS, bool GRID, int UV, bool TRI = false>
constexpr auto sum_kernel() {
  if constexpr (TRI)
    return &vrl_sum_tri_kernel<PHASE, SHORT_VRLS>;
  else if constexpr (UV > 0)
    return &vrl_sum_kernel<PHASE, SHORT_VRLS, GRID, UV, GRID_MIN_BLOCKS>;
  else
    return &vrl_sum_kernel<PHASE, SHORT_VRLS, GRID, UV>;
}

// --- the homogeneous sum (kernel 1): the flat sweep with the plane
// pre-reject (vrl_common.cuh PlaneTris), its triangles' plane pack in
// shared memory

// The plane pack (PlaneTris) of T triangles (TRI_COLS each: p0, e1, e2):
// n = e1 x e2 and off = n . p0 in float64 rounded to nearest (the
// products of two floats are exact in float64, so n is the correctly
// rounded cross product), the margin's k = PLANE_MARGIN |e1|_inf
// |e2|_inf and k0 = k |p0|_inf rounded up; then p0, e1, e2 as they are.
__global__ void plane_pack_kernel(const float* __restrict__ tris, int T,
                                  float4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* tr = tris + (size_t)t * TRI_COLS;
  const double e1[3] = {tr[3], tr[4], tr[5]}, e2[3] = {tr[6], tr[7], tr[8]};
  const float n[3] = {(float)(e1[1] * e2[2] - e1[2] * e2[1]),
                      (float)(e1[2] * e2[0] - e1[0] * e2[2]),
                      (float)(e1[0] * e2[1] - e1[1] * e2[0])};
  const double off = (double)n[0] * tr[0] + (double)n[1] * tr[1] + (double)n[2] * tr[2];
  auto inf_norm = [](double x, double y, double z) {
    return fmax(fmax(fabs(x), fabs(y)), fabs(z));
  };
  const double k = (double)PLANE_MARGIN * inf_norm(e1[0], e1[1], e1[2]) *
                   inf_norm(e2[0], e2[1], e2[2]);
  const double k0 = k * inf_norm(tr[0], tr[1], tr[2]);
  float4* o = out + (size_t)PLANE_F4 * t;
  o[0] = make_float4(n[0], n[1], n[2], (float)off);
  o[1] = make_float4(__double2float_ru(k), __double2float_ru(k0), tr[0], tr[1]);
  o[2] = make_float4(tr[2], tr[3], tr[4], tr[5]);
  o[3] = make_float4(tr[6], tr[7], tr[8], 0.0f);
}

// MAT: the material instantiation, which evaluates the eye hit's smooth
// BSDF from the material table (M rows staged in shared memory after the
// VRL chunk; vrl_common.cuh eval_smooth) and reads the ray pack's MATID
// row; MAT = false, the diffuse sum, ignores mat_table, M and rt.
template <int PHASE, bool SHORT_VRLS, int MODE, bool MAT>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_plane_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                         int N, const float4* __restrict__ planes, int T,
                         const float* __restrict__ med, const float* __restrict__ mat_table,
                         int M, const float* __restrict__ rt, const float* __restrict__ uniforms,
                         uint32_t seed, int svv, int svs, float* __restrict__ partial,
                         unsigned long long* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  float4* s_planes = smem4;  // (T * PLANE_F4)
  float* s_vrl = reinterpret_cast<float*>(smem4 + T * PLANE_F4);
  float* s_mat = s_vrl + VRL_ROWS * VRL_CHUNK;  // MAT: (M, MAT_COLS)
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  for (int i = threadIdx.x; i < T * PLANE_F4; i += blockDim.x) s_planes[i] = planes[i];
  const int nc = stage_block(nullptr, 0, vrls, N, n0, nullptr, s_vrl);
  Mats mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, s_mat);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Ray ray = load_ray(rays, B, b);
  if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
  const Medium m(med, std::true_type{});  // with the pack's extension
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  CheckCounts cnt = {0u, 0u, 0u, 0u, 0u};
  const PlaneTris<MODE> occl{s_planes, T, &cnt};

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray.ok && c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
    const int n = n0 + c;
    const VrlPair p = pair_at<false>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS, MAT>(
        ray, p, m, draw, svv, svs, occl,
        [&](int family, const float* t) {
          const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
        },
        &mats);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
  if (MODE == MODE_CHECK) add_check_counts(cnt, counts);
}

// dynamic shared memory of the homogeneous sum, in bytes, with T
// triangles and M material rows (0 for the diffuse sum)
size_t plane_smem_bytes(int T, int M = 0) {
  return (size_t)T * PLANE_F4 * sizeof(float4) +
         ((size_t)VRL_ROWS * VRL_CHUNK + (size_t)M * MAT_COLS) * sizeof(float);
}

// The instantiation of kernel 1 for (phase, short VRLs, mode, material).
using PlaneKernel = void (*)(const float*, int, const float*, int, const float4*, int,
                             const float*, const float*, int, const float*, const float*,
                             uint32_t, int, int, float*, unsigned long long*);

template <bool MAT, class Phase, class Short>
PlaneKernel plane_kernel(Phase, Short, int mode) {
  constexpr int P = Phase::value;
  constexpr bool S = Short::value;
  if (mode == MODE_CHECK) return &vrl_sum_plane_kernel<P, S, MODE_CHECK, MAT>;
  if (mode == MODE_NO_REJECT) {
    if constexpr (P == 2)
      return nullptr;  // the mixture has no timing form
    else
      return &vrl_sum_plane_kernel<P, S, MODE_NO_REJECT, MAT>;
  }
  return &vrl_sum_plane_kernel<P, S, MODE_SUM, MAT>;
}


// Launches kernel 1 and the chunk reduction on `stream`: the plane pack
// of the T triangles into `planes` (T * PLANE_F4 float4s of scratch),
// then the sum, in `mode` (MODE_CHECK adds its counts to
// counts[N_CHECK]). Returns a cudaError_t (0 = launched).
int launch_homog(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                 const float* med, const float* mat_table, int M, const float* rt,
                 const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                 int phase_kind, float* planes, int mode, unsigned long long* counts,
                 float* partial, int n_chunks, float* out, void* stream) {
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK || n_chunks > MAX_GRID_Y ||
      !mode_ok<true, true>(mode, counts) || !mats_ok(mat_table, M, rt))
    return (int)cudaErrorInvalidValue;
  PlaneKernel kernel = nullptr;
  const int d = dispatch<true>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    kernel = M > 0 ? plane_kernel<true>(phase, short_, mode)
                   : plane_kernel<false>(phase, short_, mode);
  });
  if (d != 0) return d;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int pack = pack_planes<true>(tris, T, planes, stream);
  if (pack != 0) return pack;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = plane_smem_bytes(T, M);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, reinterpret_cast<const float4*>(tris),
                                          T, med, mat_table, M, rt, uniforms, seed, svv, svs,
                                          partial, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<float><<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

// dynamic shared memory of the sum, in bytes, with T triangles and M
// material rows (0 but for the material forms)
template <bool GRID>
size_t sum_smem_bytes(int T, int M = 0) {
  return (size_t)(T * TRI_COLS + (GRID ? GRID_VRL_ROWS : VRL_ROWS) * VRL_CHUNK +
                  (GRID ? GRID_MED_LEN + (NQ + 1) * RAY_BLOCK : 0) + M * MAT_COLS) *
         sizeof(float);
}

// Launches the sum and the chunk reduction on `stream` (M > 0: the
// grid material form, on the material table mat_table, M and rt);
// returns a cudaError_t (0 = launched).
template <bool GRID>
int launch_sum(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
               const float* med, GridArgs grid, int trilinear, const float* mat_table, int M,
               const float* rt, const float* uniforms, unsigned int seed, int svv, int svs,
               int short_vrls, int phase_kind, float* partial, int n_chunks, float* out,
               void* stream) {
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1) || n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK ||
      n_chunks > MAX_GRID_Y || !grid_ok<GRID>(grid) || !mats_ok(mat_table, M, rt))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = sum_smem_bytes<GRID>(T, M);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t attr = cudaSuccess;
  if (M > 0) {
    dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
      constexpr int P = decltype(phase)::value;
      constexpr bool S = decltype(short_)::value;
      auto kernel = trilinear ? &vrl_sum_mat_kernel<P, S, true> : &vrl_sum_mat_kernel<P, S, false>;
      attr = allow_smem(kernel, smem);
      if (attr == cudaSuccess)
        kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T, med, grid, mat_table,
                                                M, rt, uniforms, seed, svv, svs, partial);
    });
  } else {
    dispatch_read<GRID>(phase_kind, short_vrls, grid.uv_steps, trilinear,
                        [&](auto phase, auto short_, auto uv, auto tri) {
                          auto kernel =
                              sum_kernel<decltype(phase)::value, decltype(short_)::value, GRID,
                                         decltype(uv)::value, decltype(tri)::value>();
                          attr = allow_smem(kernel, smem);
                          if (attr == cudaSuccess)
                            kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, tris, T,
                                                                    med, grid, uniforms, seed,
                                                                    svv, svs, partial);
                        });
  }
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<float><<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int alvrl_vrl_chunk() { return VRL_CHUNK; }
int alvrl_max_tris() { return MAX_TRIS; }
// the U-V step count that the grid sum and its VJP are compiled for
int alvrl_uv_steps() { return UV_STEPS; }
const char* alvrl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int alvrl_plane_f4() { return PLANE_F4; }

// The homogeneous sum (kernel 1). `med` is the medium pack with its
// extension (ops/pack.py pack_medium: MED_LEN + 2 + 3 K floats);
// phase_kind 0 (HG), 1 (Rayleigh) or 4 (the mixture of the extension's K
// components, which has no mode 2); any other kind launches nothing and
// returns cudaErrorInvalidValue. `planes` is (T, 4 PLANE_F4) float
// scratch for the triangles' plane pack, `partial` (n_chunks, 3, B)
// scratch, `out` (3, B); `uniforms` may be null (Philox stream from
// `seed`). mode: 0 the sum, 1 the checking instantiation (counts:
// N_CHECK totals, zeroed by the caller: segments, triangles tested by
// the Wald-only sweep, those skipped by the pre-reject, skipped
// triangles that block, segments decided differently), 2 the sweep
// without the pre-reject (timing only).
//
// mat_table (M, MAT_COLS), M and rt (M, RT_COS, RT_ALPHA): the material
// table (ops/pack.py pack_materials) for the material instantiation, whose
// rays carry the hit's material id in row MATID; null, 0 and null for the
// diffuse sum. tex 1 (with a table): the textured form (vrl_tex.cuh), whose
// rays are the textured pack, in mode 0 or 1.
int alvrl_vrl_sum(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                  const float* med, const float* mat_table, int M, const float* rt, int tex,
                  const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                  int phase_kind, float* planes, int mode, unsigned long long* counts,
                  float* partial, int n_chunks, float* out, void* stream) {
  if (tex)
    return alvrl_vrl_sum_tex(rays, B, vrls, N, tris, T, med, mat_table, M, rt, uniforms, seed,
                             svv, svs, short_vrls, phase_kind, planes, mode, counts, partial,
                             n_chunks, out, stream);
  return launch_homog(rays, B, vrls, N, tris, T, med, mat_table, M, rt, uniforms, seed, svv, svs,
                      short_vrls, phase_kind, planes, mode, counts, partial, n_chunks, out,
                      stream);
}

int alvrl_max_mats() { return MAX_MATS; }

// The plane pack of T triangles into `out` (T, 4 PLANE_F4), as kernel 1
// makes it; returns a cudaError_t.
int alvrl_plane_pack(const float* tris, int T, float* out, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  plane_pack_kernel<<<(T + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      tris, T, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// The grid-medium sum: the grid packs (ops/pack.py), the supersampled
// density (nz, ny, nx) and the U-V quadrature's step count; trilinear 1:
// the trilinear form, on the trilinear medium pack and the density
// itself (nz, ny, nx), each at least 2; mat_table, M and rt: the
// material table of the material form (either read, the run-time step
// count), whose rays carry the hit's material id in row GRID_MATID (null,
// 0, null: the diffuse sum); tex 1 (with a table): the textured forms
// (vrl_sum_grid_tex.cu), whose rays are the grid textured pack; the rest
// as alvrl_vrl_sum.
int alvrl_vrl_sum_hetero(const float* rays, int B, const float* vrls, int N, const float* tris,
                         int T, const float* med, const float* mat_table, int M, const float* rt,
                         int tex, const float* density, int nz, int ny, int nx, int uv_steps,
                         int trilinear, const float* uniforms, unsigned int seed, int svv,
                         int svs, int short_vrls, int phase_kind, float* partial, int n_chunks,
                         float* out, void* stream) {
  if (tex)
    return alvrl_vrl_sum_hetero_tex(rays, B, vrls, N, tris, T, med, mat_table, M, rt, density, nz,
                                    ny, nx, uv_steps, trilinear, uniforms, seed, svv, svs,
                                    short_vrls, phase_kind, partial, n_chunks, out, stream);
  if (trilinear && (nz < 2 || ny < 2 || nx < 2)) return (int)cudaErrorInvalidValue;
  return launch_sum<true>(rays, B, vrls, N, tris, T, med, GridArgs{density, nz, ny, nx, uv_steps},
                          trilinear, mat_table, M, rt, uniforms, seed, svv, svs, short_vrls,
                          phase_kind, partial, n_chunks, out, stream);
}

// The sum's blocks resident on one SM for the instantiation a launch
// with these arguments takes, as vrl_common.cuh's occupancy.
int alvrl_vrl_sum_occupancy(int grid, int T, int uv_steps, int phase_kind, int short_vrls,
                            int* blocks) {
  if (!grid) {  // kernel 1, the sum as launch_homog takes it
    if (T < 0 || T > MAX_TRIS || (phase_kind != 0 && phase_kind != 1))
      return (int)cudaErrorInvalidValue;
    PlaneKernel kernel = nullptr;
    dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
      kernel = plane_kernel<false>(phase, short_, MODE_SUM);
    });
    const size_t smem = plane_smem_bytes(T);
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, RAY_BLOCK, smem);
    return (int)err;
  }
  // the grid sum (the homogeneous medium returned above, so its branch
  // of the query names the grid kernel too and compiles no other)
  return occupancy(
      grid, T, uv_steps, phase_kind, short_vrls, blocks,
      [](auto, auto phase, auto short_, auto uv) {
        return sum_kernel<decltype(phase)::value, decltype(short_)::value, true,
                          decltype(uv)::value>();
      },
      [](auto, int n_tris) { return sum_smem_bytes<true>(n_tris); });
}

}  // extern "C"
