// VRL x eye-ray sum for homogeneous media, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas (its body `_kernel`
// with hetero=False, clustered=False, r_mode=False and the triangle sweep).
// For each eye ray b it returns the sum over the valid VRLs n of the
// vol-vol and vol-surf estimators, (3, B) float32, not normalised by the
// particle count. Plain PyTorch twin: ops/vrl_sum.py:vrl_sum_reference.
//
// What bounds it on the H100: fp32 ALU and SFU throughput. One
// pair-sample costs about a thousand flops and twenty transcendentals
// (sinh/asinh, atan, tan, exp, sqrt), against an input of under 1 MB,
// so neither device memory nor tensor cores matter. The design keeps the
// whole working set on chip and spreads the pairs over enough threads:
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pack layouts: ops/pack.py
constexpr int RO = 0, RD = 3, HP = 6, NG = 9, ALB = 12, TAU = 15, VALID = 18;
constexpr int VS = 0, VE = 3, VP = 6, VVALID = 9, VRL_ROWS = 10;
constexpr int TRI_COLS = 9;

constexpr int RAY_BLOCK = 128;
constexpr int VRL_CHUNK = 32;
constexpr int MAX_TRIS = 1024;  // shared memory: 36 KB of triangles
constexpr int MAX_GRID_Y = 65535;

constexpr float INV_FOURPI = 0.0795774715459476679f;
constexpr float INV_PI = 0.318309886183790672f;
constexpr float RAYLEIGH_NORM = 0.0596831036594607510f;  // 3 / (16 pi)
constexpr float H_EPS = 1e-6f;

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 operator+(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 operator-(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 operator*(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The uniforms of one (ray, VRL) pair, drawn in order d = 0, 1, 2, ...
struct PairUniforms {
  const float* injected;  // this pair's row of `uniforms`, or nullptr
  uint32_t b, n, seed;
  uint4 block;
  int block_j;

  __device__ float operator()(int d) {
    if (injected) return injected[d];
    const int j = d >> 2;
    if (j != block_j) {
      block = philox4x32_10(make_uint4(b, n, (uint32_t)j, 0u), seed, 0u);
      block_j = j;
    }
    const int w = d & 3;
    const uint32_t bits = w == 0 ? block.x : w == 1 ? block.y : w == 2 ? block.z : block.w;
    return (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  }
};

template <int PHASE>
__device__ __forceinline__ float phase_eval(float g, float c) {
  if (PHASE == 1) return RAYLEIGH_NORM * (1.0f + c * c);
  const float temp = fmaxf(1.0f + g * g + 2.0f * g * c, 1e-12f);
  return INV_FOURPI * (1.0f - g * g) / (temp * sqrtf(temp));
}

// Any triangle blocking the open segment p -> q (ends shrunk by
// 1e-3 * max(|q - p|, 1))? Division-free Wald test.
__device__ bool occluded(const float* __restrict__ s_tri, int T, f3 p, f3 q) {
  const f3 dd = q - p;
  const float len2 = dot3(dd, dd);
  const float idist = 1.0f / sqrtf(fmaxf(len2, 1e-30f));
  const float dist = len2 * idist;
  const f3 u = dd * idist;
  const float lo = 1e-3f * fmaxf(dist, 1.0f);
  const float hi = dist - lo;
  for (int t = 0; t < T; ++t) {
    const float* tr = s_tri + t * TRI_COLS;
    const f3 p0 = {tr[0], tr[1], tr[2]};
    const f3 e1 = {tr[3], tr[4], tr[5]};
    const f3 e2 = {tr[6], tr[7], tr[8]};
    const f3 pv = cross3(u, e2);
    const float det = dot3(e1, pv);
    const float sgn = det >= 0.0f ? 1.0f : -1.0f;
    const float adet = det * sgn;
    const f3 tv = p - p0;
    const float uu = dot3(tv, pv) * sgn;
    const f3 qv = cross3(tv, e1);
    const float vv = dot3(u, qv) * sgn;
    const float tt = dot3(e2, qv) * sgn;
    float mn = fminf(uu, vv);
    mn = fminf(mn, adet - (uu + vv));
    mn = fminf(mn, tt - lo * adet);
    mn = fminf(mn, hi * adet - tt);
    mn = fminf(mn, adet - 1e-12f);
    if (mn > 0.0f) return true;
  }
  return false;
}

// Equi-angular (Kulla-Fajardo) sampling of a point at arc length `arc`
// along the segment a + t * dir, t in [0, len], around point x.
__device__ __forceinline__ void kulla(f3 a, f3 dir, float len, f3 x, float u, float& arc,
                                      float& pdf) {
  const float dot_pr = dot3(dir, x - a);
  const f3 dd = x - (a + dir * dot_pr);
  const float dis = fmaxf(sqrtf(dot3(dd, dd)), H_EPS);
  const float dist_ai = fabsf(dot_pr);
  const float dist_ib = fabsf(len - dot_pr);
  float angle_a = atanf(dist_ai / dis);
  float angle_b = atanf(dist_ib / dis);
  const bool pos = dot_pr > 0.0f;
  if (pos) angle_a = -angle_a;
  if (pos && dist_ai > len) angle_b = -angle_b;
  const float t = dis * tanf((1.0f - u) * angle_a + u * angle_b);
  const float span = angle_b - angle_a;
  pdf = fabsf(span) > 1e-12f ? dis / fmaxf(span * (dis * dis + t * t), 1e-30f) : 0.0f;
  arc = dot_pr + t;
}

// Parameter tc in [0, 1] of the point of segment (s, s + v) closest to
// segment (o, o + u), and the distance between the closest points.
__device__ __forceinline__ void seg_seg_closest(f3 o, f3 u, f3 s, f3 v, float& tc, float& h) {
  const f3 w = o - s;
  const float a = dot3(u, u), b = dot3(u, v), c = dot3(v, v);
  const float d = dot3(u, w), e = dot3(v, w);
  const float denom = a * c - b * b;
  const bool par = denom < 1e-9f * a * c + 1e-30f;
  float s_n = par ? 0.0f : b * e - c * d;
  float s_d = par ? 1.0f : denom;
  float t_n = par ? e : a * e - b * d;
  float t_d = par ? c : denom;
  const bool below = s_n < 0.0f, above = s_n > s_d;
  t_n = below ? e : (above ? e + b : t_n);
  t_d = (below || above) ? c : t_d;
  s_n = below ? 0.0f : (above ? s_d : s_n);
  const bool t_below = t_n < 0.0f, t_above = t_n > t_d;
  const float s_lo = fminf(fmaxf(-d, 0.0f), a);
  const float s_hi = fminf(fmaxf(-d + b, 0.0f), a);
  s_n = t_below ? s_lo : (t_above ? s_hi : s_n);
  s_d = (t_below || t_above) ? fmaxf(a, 1e-30f) : s_d;
  t_n = t_below ? 0.0f : (t_above ? t_d : t_n);
  const float sc = s_n / fmaxf(s_d, 1e-30f);
  tc = t_n / fmaxf(t_d, 1e-30f);
  const f3 dp = (o + u * sc) - (s + v * tc);
  h = sqrtf(fmaxf(dot3(dp, dp), 0.0f));
}

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
  const int nc = min(VRL_CHUNK, N - n0);
  for (int i = threadIdx.x; i < T * TRI_COLS; i += blockDim.x) s_tri[i] = tris[i];
  for (int i = threadIdx.x; i < VRL_ROWS * VRL_CHUNK; i += blockDim.x) {
    const int r = i / VRL_CHUNK, c = i % VRL_CHUNK;
    s_vrl[i] = c < nc ? vrls[(size_t)r * N + n0 + c] : 0.0f;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  auto ray = [&](int r) { return rays[(size_t)r * B + b]; };
  auto ray3 = [&](int r) { return f3{ray(r), ray(r + 1), ray(r + 2)}; };
  const f3 o = ray3(RO), d = ray3(RD), hp = ray3(HP), ng = ray3(NG);
  const float alb[3] = {ray(ALB), ray(ALB + 1), ray(ALB + 2)};
  const float tau[3] = {ray(TAU), ray(TAU + 1), ray(TAU + 2)};
  const bool ray_ok = ray(VALID) > 0.5f;

  const float sig_t[3] = {med[0], med[1], med[2]};
  const float sig_s[3] = {med[3], med[4], med[5]};
  const float g = med[6], msw = med[7];

  const f3 ee = hp - o;  // eye segment
  const float elen = sqrtf(fmaxf(dot3(ee, ee), 1e-30f));
  const bool alb_any = (alb[0] + alb[1] + alb[2]) > 0.0f;
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;

  // short-VRL pdfFailure of the VRL segment up to arc length x
  auto pdf_failure = [&](float x) {
    float pf = (expf(-sig_t[0] * x) + expf(-sig_t[1] * x) + expf(-sig_t[2] * x)) * (1.0f / 3.0f);
    return msw * pf + (1.0f - msw);
  };

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray_ok && c < nc; ++c) {
    auto vrl = [&](int r) { return s_vrl[r * VRL_CHUNK + c]; };
    if (vrl(VVALID) <= 0.5f) continue;
    const int n = n0 + c;
    const f3 s = {vrl(VS), vrl(VS + 1), vrl(VS + 2)};
    const f3 vd = f3{vrl(VE), vrl(VE + 1), vrl(VE + 2)} - s;
    const float pw[3] = {vrl(VP), vrl(VP + 1), vrl(VP + 2)};
    const float vlen = sqrtf(fmaxf(dot3(vd, vd), 1e-30f));
    const float ivl = 1.0f / vlen;
    const f3 uv = vd * ivl;  // unit VRL direction

    float tc, h_close;
    seg_seg_closest(o, ee, s, vd, tc, h_close);
    const float cos_theta = dot3(d, uv);
    const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
    const bool near_par = sin_theta < 1e-4f;
    const float sin_safe = fmaxf(sin_theta, 1e-4f);
    const float h = fmaxf(h_close, H_EPS);
    const float arc_h = tc * vlen;  // closest point's arc position on the VRL
    const float a0 = asinhf(-arc_h / h * sin_safe);
    const float a1 = asinhf((vlen - arc_h) / h * sin_safe);

    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};

    // vol-vol: V on the VRL ~ inverse distance, U on the eye ray ~ equi-angular around V
    for (int i = 0; i < svv; ++i) {
      const float u1 = draw(2 * i), u2 = draw(2 * i + 1);
      float arc_v, pdf_v;
      if (near_par) {
        arc_v = u1 * vlen;
        pdf_v = ivl;
      } else {
        const float new_v = h * sinhf(a0 + u1 * (a1 - a0)) / sin_safe;
        const float inv_dist =
            1.0f / sqrtf(fmaxf(h * h + new_v * new_v * sin_safe * sin_safe, 1e-30f));
        const float denom = fmaxf((a1 - a0) / sin_safe, 1e-30f);
        arc_v = new_v + arc_h;
        pdf_v = inv_dist / denom;
      }
      const f3 vp = s + uv * arc_v;
      float arc_u, pdf_u;
      kulla(o, d, elen, vp, u2, arc_u, pdf_u);
      const f3 up = o + d * arc_u;
      const float pdf = pdf_v * pdf_u;
      const f3 duv = up - vp;
      const float d_uv2 = dot3(duv, duv);
      if (!(d_uv2 > 0.0f && pdf > 0.0f)) continue;
      if (occluded(s_tri, T, up, vp)) continue;
      const float d_uv = sqrtf(fmaxf(d_uv2, 1e-30f));
      const f3 vu = duv * (1.0f / d_uv);
      const float ph_u = phase_eval<PHASE>(g, dot3(vu, d));
      const float ph_v = phase_eval<PHASE>(g, -dot3(uv, vu));
      float geo = ph_u * ph_v / fmaxf(pdf * d_uv2, 1e-30f);
      const float d_sv = fabsf(arc_v);
      if (SHORT_VRLS) geo = geo / fmaxf(pdf_failure(d_sv), 1e-30f);
      const float path = fabsf(arc_u) + d_uv + d_sv;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        acc[ch] += pw[ch] * sig_s[ch] * sig_s[ch] * expf(-sig_t[ch] * path) * geo * inv_vv;
    }

    // vol-surf: V on the VRL ~ equi-angular around the eye ray's hit point
    for (int k = 0; k < svs && alb_any; ++k) {
      const float u1 = draw(2 * svv + k);
      float arc_v, pdf_v;
      kulla(s, uv, vlen, hp, u1, arc_v, pdf_v);
      const f3 vp = s + uv * arc_v;
      const f3 duv = hp - vp;
      const float d_uv2 = dot3(duv, duv);
      if (!(d_uv2 > 0.0f && pdf_v > 0.0f)) continue;
      if (occluded(s_tri, T, hp, vp)) continue;
      const float d_uv = sqrtf(fmaxf(d_uv2, 1e-30f));
      const f3 vu = duv * (1.0f / d_uv);
      const float cos_o = fmaxf(-dot3(ng, vu), 0.0f);
      const float ph_v = phase_eval<PHASE>(g, -dot3(uv, vu));
      float geo = ph_v * cos_o * INV_PI / fmaxf(pdf_v * d_uv2, 1e-30f);
      const float d_sv = fabsf(arc_v);
      if (SHORT_VRLS) geo = geo / fmaxf(pdf_failure(d_sv), 1e-30f);
      const float path = d_uv + d_sv;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        acc[ch] += pw[ch] * sig_s[ch] * alb[ch] * tau[ch] * expf(-sig_t[ch] * path) * geo * inv_vs;
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
}

// out[i] = sum over chunks of partial[chunk, i], in chunk order.
__global__ void reduce_chunks(const float* __restrict__ partial, int n_chunks, int len,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * len + i];
  out[i] = s;
}

template <int PHASE, bool SHORT_VRLS>
void launch(dim3 grid, size_t smem, cudaStream_t st, const float* rays, int B, const float* vrls,
            int N, const float* tris, int T, const float* med, const float* uniforms,
            uint32_t seed, int svv, int svs, float* partial) {
  vrl_sum_kernel<PHASE, SHORT_VRLS><<<grid, RAY_BLOCK, smem, st>>>(
      rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
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
  if (phase_kind == 0) {
    if (short_vrls)
      launch<0, true>(grid, smem, st, rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
    else
      launch<0, false>(grid, smem, st, rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
  } else {
    if (short_vrls)
      launch<1, true>(grid, smem, st, rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
    else
      launch<1, false>(grid, smem, st, rays, B, vrls, N, tris, T, med, uniforms, seed, svv, svs, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_chunks<<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
