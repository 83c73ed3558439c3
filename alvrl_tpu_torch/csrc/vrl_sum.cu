// VRL x eye-ray sum for homogeneous media, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas (its body `_kernel`
// with hetero=False, clustered=False, r_mode=False and the triangle sweep).
// For each eye ray b it returns the sum over the valid VRLs n of the
// vol-vol and vol-surf estimators, (3, B) float32, not normalised by the
// particle count. Plain PyTorch twin: ops/vrl_sum.py:vrl_sum_reference.
// The samplers, shared with the VJP (vrl_sum_bwd.cu), are in
// vrl_common.cuh.
//
// What bounds it on the H100: fp32 ALU and SFU throughput. One
// pair-sample costs about 150 float32 operations and 20 special-function
// operations (sqrt, division, exp; beside sinh/asinh, atan, tan), and 59
// operations per triangle of its shadow sweep, as chip_smoke.py's OPS
// counts them, against an input of under 1 MB, so neither device memory
// nor tensor cores matter. The design keeps the whole working set on chip
// and spreads the pairs over enough threads:
//   * grid = ray tiles (RAY_BLOCK threads, one ray each) x VRL chunks of
//     VRL_CHUNK; one thread per ray alone would fill about a sixteenth
//     of the card at 16k rays, so the VRL axis is split as well;
//   * each block stages its VRL chunk and all T triangles in shared
//     memory; every thread then reads the same triangle at the same
//     time (a broadcast, no bank conflicts);
//   * each thread loops over its chunk in a fixed order; partial sums go
//     to (n_chunks, 3, B) scratch and a second kernel adds the chunks in
//     a fixed order, so the result is deterministic;
//   * shadow segments use the division-free Wald test, one sweep over
//     the triangles per sample segment, with an early exit on the first
//     blocker;
//   * random numbers come from a counter-based Philox4x32-10, so the
//     stream does not depend on the tiling: key (seed, 0), counter
//     (b, n, j, 0), draw d of a pair is word d % 4 of call j = d / 4,
//     u = (bits >> 8) * 2^-24. Draw order per pair: the vol-vol samples'
//     (V, U) draws, then the vol-surf samples' draws. `uniforms`, when
//     given, is read instead, as (B, N, 2 * svv + svs) float32.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_common.cuh"

namespace {

template <int PHASE, bool SHORT_VRLS>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls, int N,
                   const float* __restrict__ tris, int T, const float* __restrict__ med,
                   const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                   float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* s_tri = smem;                   // (T, TRI_COLS)
  float* s_vrl = smem + T * TRI_COLS;    // (VRL_ROWS, VRL_CHUNK)
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  const int nc = stage_block(tris, T, vrls, N, n0, s_tri, s_vrl);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray ray = load_ray(rays, B, b);
  const Medium m(med);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray.ok && c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
    const int n = n0 + c;
    const VrlPair p = pair_setup(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS>(ray, p, m, draw, svv, svs, s_tri, T,
                                  [&](int family, const float* t) {
                                    const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
                                    for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
                                  });
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
}

}  // namespace

extern "C" {

int alvrl_vrl_chunk() { return VRL_CHUNK; }
int alvrl_max_tris() { return MAX_TRIS; }
const char* alvrl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launches the sum and the chunk reduction on `stream`; returns a
// cudaError_t (0 = launched). `partial` is (n_chunks, 3, B) scratch,
// `out` is (3, B); `uniforms` may be null (Philox stream from `seed`).
int alvrl_vrl_sum(const float* rays, int B, const float* vrls, int N, const float* tris, int T,
                  const float* med, const float* uniforms, unsigned int seed, int svv, int svs,
                  int short_vrls, int phase_kind, float* partial, int n_chunks, float* out,
                  void* stream) {
  if (B <= 0 || N <= 0 || T < 0 || T > MAX_TRIS || svv < 0 || svs < 0 ||
      (phase_kind != 0 && phase_kind != 1) || n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK ||
      n_chunks > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = (size_t)(T * TRI_COLS + VRL_ROWS * VRL_CHUNK) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    vrl_sum_kernel<decltype(phase)::value, decltype(short_)::value><<<grid, RAY_BLOCK, smem, st>>>(
        rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
