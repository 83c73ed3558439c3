// VRL x eye-ray sum with BVH occlusion, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_bvh (:1415; its
// occlusion _occl_bvh, :1175): kernel 1's function (vrl_sum.cu: for each
// eye ray b the sum over the valid VRLs of the vol-vol and vol-surf
// estimators, (3, B) float32, not normalised by the particle count) with
// no cap on the triangle count. Entry point alvrl_vrl_sum_bvh; plain
// PyTorch twin ops/vrl_sum_bvh.py:vrl_sum_bvh_reference. Homogeneous
// media only, as the TPU kernel.
//
// What bounds it on the H100: fp32 ALU throughput and the divergence of
// the shadow traversals. Per pair-sample the estimator costs what it
// costs in vrl_sum.cu (about 150 float32 and 20 special-function
// operations); each shadow segment then walks a BVH: 19 operations per
// node box and 59 per triangle (chip_smoke.py's OPS, "node" and
// "triangle"), a number of each that depends on the data, which the
// counting instantiation (COUNT=true) measures. The nodes and triangles
// (32 + 36 bytes each: about 7 MB at 129,612 triangles) stay resident in
// the 50 MB L2, so device memory does not bound it. The TPU kernel
// streamed 64-triangle leaf clusters from HBM behind per-ray-group AABB
// culling, because its scalar core could not chase pointers per ray; on
// Hopper each thread walks its own segment:
//   * grid, staging and reduction are kernel 1's: ray tiles (RAY_BLOCK
//     threads, one ray each) x chunks of VRL_CHUNK VRLs staged in shared
//     memory, the Philox counter (b, n, j), partial sums to (n_chunks, 3,
//     B) scratch added in chunk order by reduce_parts (deterministic);
//   * the shadow test is the policy BvhTris: an any-hit traversal of the
//     BVH in device memory, read through the read-only path, one node
//     box (slab test with IEEE infinities for zero direction components,
//     the near and far planes picked by the sign, min/max that ignore
//     the NaN of a segment lying in a box's face) per pop, a fixed stack
//     of BVH_STACK entries in local memory (the host refuses a deeper
//     tree; the entry point refuses a depth over BVH_STACK - 1, so the
//     stack cannot overflow), an exit at the first blocker;
//   * each triangle goes through vrl_common.cuh's wald_hit, the function
//     of kernel 1's flat sweep, and the host pads every node box outward
//     (ops/vrl_sum_bvh.py:BOX_PAD), so the traversal finds every triangle
//     the sweep finds: both kernels give the same sums, bit for bit,
//     given the same samples;
//   * the 32 rays of a warp share a VRL at each loop step, but their
//     segments differ, so the traversals diverge; this simple kernel
//     leaves that as it is, and the counting instantiation writes down
//     the node and triangle tests per segment (PERF.md).
// Precise math functions throughout (no --use_fast_math).

#include "vrl_common.cuh"

namespace {

constexpr int BVH_STACK = 64;  // stack entries: trees up to BVH_STACK - 1 deep

// A thread's traversal counts (COUNT=true): node boxes tested, triangles
// tested, shadow segments tested.
struct BvhCounts {
  uint32_t nodes, tris, segments;
};

// Does segment s, with per-axis reciprocal directions inv, overlap the
// box (lo, hi) within its open interval (lo, hi)? On an axis where the
// segment's direction is 0, inv is +-inf, and the near and far distances
// are -inf / +inf (outside the slab: +inf / -inf), or NaN where the
// segment lies in the box's face plane; fmaxf and fminf drop that NaN,
// leaving the axis unconstrained.
__device__ __forceinline__ bool slab_overlaps(const Segment& s, f3 inv, float4 lo, float4 hi) {
  const float nx = ((inv.x < 0.0f ? hi.x : lo.x) - s.p.x) * inv.x;
  const float fx = ((inv.x < 0.0f ? lo.x : hi.x) - s.p.x) * inv.x;
  const float ny = ((inv.y < 0.0f ? hi.y : lo.y) - s.p.y) * inv.y;
  const float fy = ((inv.y < 0.0f ? lo.y : hi.y) - s.p.y) * inv.y;
  const float nz = ((inv.z < 0.0f ? hi.z : lo.z) - s.p.z) * inv.z;
  const float fz = ((inv.z < 0.0f ? lo.z : hi.z) - s.p.z) * inv.z;
  const float t0 = fmaxf(fmaxf(fmaxf(s.lo, nx), ny), nz);
  const float t1 = fminf(fminf(fminf(s.hi, fx), fy), fz);
  return t0 <= t1;
}

// The BVH occlusion policy. nodes: (n_nodes, 2) float4, (lo.xyz, a) and
// (hi.xyz, b) with a, b int32 bits: an inner node's children a and b, or
// a leaf's first triangle a and -count b; node 0 is the root. tris: the
// leaf-ordered triangles (T, TRI_COLS), pack_tris' p0, e1, e2.
template <bool COUNT>
struct BvhTris {
  const float4* __restrict__ nodes;
  const float* __restrict__ tris;
  int n_nodes;
  BvhCounts* counts;

  __device__ bool operator()(f3 p, f3 q) const {
    if (n_nodes == 0) return false;
    const Segment s = make_segment(p, q);
    const f3 inv = {1.0f / s.u.x, 1.0f / s.u.y, 1.0f / s.u.z};
    if (COUNT) ++counts->segments;
    int stack[BVH_STACK];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int n = stack[--sp];
      const float4 lo = __ldg(nodes + 2 * n), hi = __ldg(nodes + 2 * n + 1);
      if (COUNT) ++counts->nodes;
      if (!slab_overlaps(s, inv, lo, hi)) continue;
      const int a = __float_as_int(lo.w), b = __float_as_int(hi.w);
      if (b < 0) {
        for (int t = a; t < a - b; ++t) {
          if (COUNT) ++counts->tris;
          const float* tr = tris + (size_t)t * TRI_COLS;
          if (wald_hit(s, {__ldg(tr), __ldg(tr + 1), __ldg(tr + 2)},
                       {__ldg(tr + 3), __ldg(tr + 4), __ldg(tr + 5)},
                       {__ldg(tr + 6), __ldg(tr + 7), __ldg(tr + 8)}))
            return true;
        }
      } else {
        stack[sp++] = b;
        stack[sp++] = a;
      }
    }
    return false;
  }
};

// counts (COUNT=true): the launch's totals of node tests, triangle tests,
// shadow segments tested, open vol-vol samples, open vol-surf samples.
constexpr int N_COUNTS = 5;

template <int PHASE, bool SHORT_VRLS, bool COUNT>
__global__ void __launch_bounds__(RAY_BLOCK)
    vrl_sum_bvh_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float4* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ tris, const float* __restrict__ med,
                       const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                       float* __restrict__ partial, unsigned long long* __restrict__ counts) {
  __shared__ float s_vrl[VRL_ROWS * VRL_CHUNK];
  const int chunk = blockIdx.y;
  const int n0 = chunk * VRL_CHUNK;
  const int nc = stage_block(tris, 0, vrls, N, n0, nullptr, s_vrl);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray ray = load_ray(rays, B, b);
  const Medium m(med);
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  BvhCounts cnt = {0u, 0u, 0u};
  uint32_t n_open[2] = {0u, 0u};
  const BvhTris<COUNT> occl{nodes, tris, n_nodes, &cnt};

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; ray.ok && c < nc; ++c) {
    if (s_vrl[VVALID * VRL_CHUNK + c] <= 0.5f) continue;
    const int n = n0 + c;
    const VrlPair p = pair_at<false>(ray, s_vrl, c);
    PairUniforms draw{uniforms ? uniforms + ((size_t)b * N + n) * n_draws : nullptr,
                      (uint32_t)b, (uint32_t)n, seed, make_uint4(0u, 0u, 0u, 0u), -1};
    pair_terms<PHASE, SHORT_VRLS>(ray, p, m, draw, svv, svs, occl,
                                  [&](int family, const float* t) {
                                    if (COUNT) ++n_open[family];
                                    const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
                                    for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
                                  });
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
  if (COUNT) {
    const uint32_t all[N_COUNTS] = {cnt.nodes, cnt.tris, cnt.segments, n_open[0], n_open[1]};
#pragma unroll
    for (int i = 0; i < N_COUNTS; ++i) atomicAdd(counts + i, (unsigned long long)all[i]);
  }
}

}  // namespace

extern "C" {

int alvrl_bvh_stack() { return BVH_STACK; }

// The BVH-occlusion sum. nodes (n_nodes, 8) and tris (T, TRI_COLS) are
// ops/vrl_sum_bvh.py:pack_bvh_tris' pack, depth its tree's depth (edges
// from the root to the deepest leaf); the rest as alvrl_vrl_sum.
// `counts`, when not null, selects the counting instantiation and
// receives N_COUNTS totals (zeroed by the caller). Returns a cudaError_t
// (0 = launched).
int alvrl_vrl_sum_bvh(const float* rays, int B, const float* vrls, int N, const float* nodes,
                      int n_nodes, const float* tris, int T, int depth, const float* med,
                      const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                      int phase_kind, float* partial, int n_chunks, float* out,
                      unsigned long long* counts, void* stream) {
  if (B <= 0 || N <= 0 || n_nodes < 0 || T < 0 || (n_nodes == 0) != (T == 0) || depth < 0 ||
      depth > BVH_STACK - 1 || svv < 0 || svs < 0 || (phase_kind != 0 && phase_kind != 1) ||
      n_chunks != (N + VRL_CHUNK - 1) / VRL_CHUNK || n_chunks > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  cudaStream_t st = (cudaStream_t)stream;
  dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
    constexpr int P = decltype(phase)::value;
    constexpr bool S = decltype(short_)::value;
    if (counts)
      vrl_sum_bvh_kernel<P, S, true><<<blocks, RAY_BLOCK, 0, st>>>(
          rays, B, vrls, N, nodes4, n_nodes, tris, med, uniforms, seed, svv, svs, partial, counts);
    else
      vrl_sum_bvh_kernel<P, S, false><<<blocks, RAY_BLOCK, 0, st>>>(
          rays, B, vrls, N, nodes4, n_nodes, tris, med, uniforms, seed, svv, svs, partial,
          nullptr);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<float><<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
