// Device code shared by kernel 7 (vrl_sum_bvh.cu) and its textured form
// (vrl_sum_bvh_tex.cu): the BVH occlusion policy (BvhTris, the
// while-while any-hit traversal over two-box nodes; vrl_sum_bvh.cu's
// header gives the design), its counts, the launches' host checks,
// stack and chunk reduction, and the block's sum (bvh_block).
// Precise math functions throughout (no --use_fast_math).

#pragma once

#include "vrl_tex.cuh"

namespace {

constexpr int BVH_STACK = 63;     // the deepest tree served, as geometry/bvh.py's traversal
constexpr int BVH_VRL_CHUNK = 1;  // VRLs per block
constexpr int NONE = 0x7fffffff;  // no node: the stack is empty

// A thread's traversal counts (COUNT=true): node fetches, boxes tested,
// triangles tested, shadow segments tested; the boxes and triangles that
// needed_work tests; segments that it decides otherwise (must be 0).
struct BvhCounts {
  uint32_t fetches, boxes, tris, segments, need_boxes, need_tris, differ;
};

// Does segment s, with per-axis reciprocal directions inv, overlap the
// box (lo, hi) within its open interval (lo, hi)? t_in: where it enters.
// On an axis where the segment's direction is 0, inv is +-inf, and the
// near and far distances are -inf / +inf (outside the slab: +inf /
// -inf), or NaN where the segment lies in the box's face plane; fmaxf
// and fminf drop that NaN, leaving the axis unconstrained.
__device__ __forceinline__ bool slab_overlaps(const Segment& s, f3 inv, float4 lo, float4 hi,
                                              float& t_in) {
  const float nx = ((inv.x < 0.0f ? hi.x : lo.x) - s.p.x) * inv.x;
  const float fx = ((inv.x < 0.0f ? lo.x : hi.x) - s.p.x) * inv.x;
  const float ny = ((inv.y < 0.0f ? hi.y : lo.y) - s.p.y) * inv.y;
  const float fy = ((inv.y < 0.0f ? lo.y : hi.y) - s.p.y) * inv.y;
  const float nz = ((inv.z < 0.0f ? hi.z : lo.z) - s.p.z) * inv.z;
  const float fz = ((inv.z < 0.0f ? lo.z : hi.z) - s.p.z) * inv.z;
  t_in = fmaxf(fmaxf(fmaxf(s.lo, nx), ny), nz);
  const float t1 = fminf(fminf(fminf(s.hi, fx), fy), fz);
  return t_in <= t1;
}

// The BVH occlusion policy. nodes: (n_nodes, 4) float4, node 0 holding
// the root's children; a node is (lo0.xyz, ref0), (hi0.xyz, -), (lo1.xyz,
// ref1), (hi1.xyz, -), the boxes and references of its two children, a
// reference (int32 bits) being an inner child's node index (>= 0) or a
// leaf's ~(first << 3 | count) (< 0: its triangles first .. first +
// count - 1). An absent child has an empty box (lo = +inf, hi = -inf).
// tris: the leaf-ordered triangles (T, TRI_COLS), pack_tris' p0, e1, e2.
// stack: this thread's column of the block's (depth, RAY_BLOCK) shared
// array.
template <bool COUNT>
struct BvhTris {
  const float4* __restrict__ nodes;
  const float* __restrict__ tris;
  int n_nodes;
  int* stack;
  BvhCounts* counts;

  // does a triangle of the leaf `ref` block s?
  __device__ __forceinline__ bool leaf_blocks(const Segment& s, int ref) const {
    const int first = ~ref >> 3, end = first + (~ref & 7);
    for (int t = first; t < end; ++t) {
      if (COUNT) ++counts->tris;
      const float* tr = tris + (size_t)t * TRI_COLS;
      if (wald_hit(s, {__ldg(tr), __ldg(tr + 1), __ldg(tr + 2)},
                   {__ldg(tr + 3), __ldg(tr + 4), __ldg(tr + 5)},
                   {__ldg(tr + 6), __ldg(tr + 7), __ldg(tr + 8)}))
        return true;
    }
    return false;
  }

  // The work the shadow function needs, for the bound (COUNT=true): the
  // box and triangle tests of the one-box-per-node any-hit traversal,
  // which tests the root's box, then each child of an overlapping inner
  // node, child 0 first, and stops at the first blocker. Returns its
  // decision, which must be the while-while's.
  __device__ bool needed_work(const Segment& s, f3 inv) const {
    float t;
    int todo[BVH_STACK + 1];  // (node << 1 | child), both children pushed
    int sp = 0;
    const float4 lo0 = __ldg(nodes), hi0 = __ldg(nodes + 1), lo1 = __ldg(nodes + 2),
                 hi1 = __ldg(nodes + 3);
    if (lo1.x > hi1.x) {  // one child: the root is that leaf
      todo[sp++] = 0;
    } else {  // the root's box, the union of its children's
      ++counts->need_boxes;
      const float4 lo = make_float4(fminf(lo0.x, lo1.x), fminf(lo0.y, lo1.y),
                                    fminf(lo0.z, lo1.z), 0.0f);
      const float4 hi = make_float4(fmaxf(hi0.x, hi1.x), fmaxf(hi0.y, hi1.y),
                                    fmaxf(hi0.z, hi1.z), 0.0f);
      if (!slab_overlaps(s, inv, lo, hi, t)) return false;
      todo[sp++] = 1;
      todo[sp++] = 0;
    }
    while (sp > 0) {
      const int e = todo[--sp];
      const float4* box = nodes + 4 * (size_t)(e >> 1) + 2 * (e & 1);
      const float4 lo = __ldg(box), hi = __ldg(box + 1);
      ++counts->need_boxes;
      if (!slab_overlaps(s, inv, lo, hi, t)) continue;
      const int ref = __float_as_int(lo.w);
      if (ref < 0) {
        const int first = ~ref >> 3, end = first + (~ref & 7);
        for (int i = first; i < end; ++i) {
          ++counts->need_tris;
          const float* tr = tris + (size_t)i * TRI_COLS;
          if (wald_hit(s, {__ldg(tr), __ldg(tr + 1), __ldg(tr + 2)},
                       {__ldg(tr + 3), __ldg(tr + 4), __ldg(tr + 5)},
                       {__ldg(tr + 6), __ldg(tr + 7), __ldg(tr + 8)}))
            return true;
        }
      } else {
        todo[sp++] = ref << 1 | 1;
        todo[sp++] = ref << 1;
      }
    }
    return false;
  }

  __device__ bool operator()(f3 p, f3 q) const {
    if (n_nodes == 0) return false;
    const Segment s = make_segment(p, q);
    const f3 inv = {1.0f / s.u.x, 1.0f / s.u.y, 1.0f / s.u.z};
    if (COUNT) {
      ++counts->segments;
      const bool hit = traverse(s, inv);
      if (hit != needed_work(s, inv)) ++counts->differ;
      return hit;
    }
    return traverse(s, inv);
  }

  // the while-while traversal: does a triangle block s?
  __device__ __forceinline__ bool traverse(const Segment& s, f3 inv) const {
    int sp = 0;
    auto pop = [&] { return sp > 0 ? stack[--sp * RAY_BLOCK] : NONE; };
    int node = 0;     // the next node: inner (>= 0), a leaf (< 0) or NONE
    int leaf = NONE;  // the postponed leaf
    while (true) {
      // inner loop: down the tree until every lane of the warp holds a leaf
      while (node != NONE && node >= 0) {
        const float4* nd = nodes + 4 * (size_t)node;
        const float4 lo0 = __ldg(nd), hi0 = __ldg(nd + 1), lo1 = __ldg(nd + 2),
                     hi1 = __ldg(nd + 3);
        if (COUNT) {
          ++counts->fetches;
          counts->boxes += 2;
        }
        float t0, t1;
        const bool h0 = slab_overlaps(s, inv, lo0, hi0, t0);
        const bool h1 = slab_overlaps(s, inv, lo1, hi1, t1);
        const int c0 = __float_as_int(lo0.w), c1 = __float_as_int(lo1.w);
        if (h0 && h1) {  // the nearer one next, the other pushed
          const bool near0 = t0 <= t1;
          stack[sp++ * RAY_BLOCK] = near0 ? c1 : c0;
          node = near0 ? c0 : c1;
        } else if (h0 || h1) {
          node = h0 ? c0 : c1;
        } else {
          node = pop();
        }
        if (node < 0 && leaf == NONE) {  // postpone the leaf
          leaf = node;
          node = pop();
        }
        if (!__any_sync(__activemask(), leaf == NONE)) break;
      }
      // leaf loop: the postponed leaf, then the node while it is a leaf
      while (leaf != NONE) {
        if (leaf_blocks(s, leaf)) return true;
        leaf = NONE;
        if (node < 0) {
          leaf = node;
          node = pop();
        }
      }
      if (node == NONE) return false;
    }
  }
};

// counts (COUNT=true): the launch's totals of node fetches, box tests,
// triangle tests, shadow segments tested, open vol-vol samples, open
// vol-surf samples, needed box tests, needed triangle tests, segments
// that needed_work decides otherwise.
constexpr int N_COUNTS = 9;

// Bounded to five resident blocks an SM (96 registers, 12-16 B of
// spill; 20 warps against 16 at its natural 110-117 registers), which
// measured 7-13 % faster on every bench scene on an H100 (PERF.md).
constexpr int BVH_MIN_BLOCKS = 5;

// the host checks of a launch: its shapes, and its tree's
// depth within the stack
bool bvh_args_ok(int B, int N, int n_nodes, int T, int depth, int svv, int svs, int n_chunks) {
  return B > 0 && N > 0 && n_nodes >= 0 && T >= 0 && (n_nodes == 0) == (T == 0) && depth >= 0 &&
         depth <= BVH_STACK && svv >= 0 && svs >= 0 &&
         n_chunks == (N + BVH_VRL_CHUNK - 1) / BVH_VRL_CHUNK && n_chunks <= MAX_GRID_Y;
}

// the stack: depth entries a thread (one for a tree that is one leaf,
// which pushes none), in bytes; 32 KB a block at the deepest tree served
size_t bvh_stack_bytes(int depth) { return (size_t)max(depth, 1) * RAY_BLOCK * sizeof(int); }

// adds the block sums in chunk order into out (3, B)
int bvh_reduce(const float* partial, int n_chunks, int B, float* out, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * B;
  reduce_parts<float><<<(len + 255) / 256, 256, 0, st>>>(partial, n_chunks, len, out);
  return (int)cudaGetLastError();
}

// The block's sum, the body of vrl_sum_bvh.cu's kernels and of the
// textured form (vrl_sum_bvh_tex.cu). EXT: the medium pack
// with its extension (the strategy's rate, a mixture's components; PHASE
// 2 the mixture), as kernel 1 reads it; MAT: the material form, its M
// table rows staged in dynamic shared memory in front of the stack and
// attached to the ray (the MATID row), as kernel 1's; MAT = false
// ignores mat_table, M and rt. TEX (with EXT and MAT): the textured form,
// each thread's three rows (vrl_tex.cuh stage_tex_rows, the ray's
// TexMats in its EyeTable) staged after the table, in front of the stack.
template <int PHASE, bool SHORT_VRLS, bool COUNT, bool EXT, bool MAT, bool TEX = false>
__device__ __forceinline__ void bvh_block(const float* __restrict__ rays, int B,
                                          const float* __restrict__ vrls, int N,
                                          const float4* __restrict__ nodes, int n_nodes,
                                          const float* __restrict__ tris,
                                          const float* __restrict__ med,
                                          const float* __restrict__ uniforms, uint32_t seed,
                                          int svv, int svs, float* __restrict__ partial,
                                          unsigned long long* __restrict__ counts,
                                          const float* __restrict__ mat_table = nullptr,
                                          int M = 0, const float* __restrict__ rt = nullptr) {
  __shared__ float s_vrl[VRL_ROWS * VRL_CHUNK];  // the chunk's columns, VRL_CHUNK apart
  extern __shared__ int s_dyn[];  // MAT: (M, MAT_COLS) floats; then (depth, RAY_BLOCK)
  int* s_stack = MAT ? s_dyn + M * MAT_COLS : s_dyn;
  if constexpr (TEX) s_stack += TEX_SMEM_FLOATS;  // after the threads' rows
  const int chunk = blockIdx.y;
  const int n0 = chunk * BVH_VRL_CHUNK;
  const int nc = stage_block(tris, 0, vrls, N, n0, nullptr, s_vrl, VRL_ROWS, BVH_VRL_CHUNK);
  EyeTable<TEX> mats{};
  if constexpr (MAT) mats = stage_mats(mat_table, M, rt, reinterpret_cast<float*>(s_dyn));
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Ray ray = load_ray(rays, B, b);
  if constexpr (MAT) attach_mat(ray, rays, B, b, mats);
  if constexpr (TEX)
    mats.tm = stage_tex_rows<false>(mats, ray.mat, rays, B, b,
                                    tex_rows(reinterpret_cast<float*>(s_dyn), M));
  const Medium m = make_medium<false, 0, EXT>(med, nullptr, GridArgs{});
  const float inv_vv = svv > 0 ? 1.0f / (float)svv : 0.0f;
  const float inv_vs = svs > 0 ? 1.0f / (float)svs : 0.0f;
  const int n_draws = 2 * svv + svs;
  BvhCounts cnt = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t n_open[2] = {0u, 0u};
  const BvhTris<COUNT> occl{nodes, tris, n_nodes, s_stack + threadIdx.x, &cnt};

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
          if (COUNT) ++n_open[family];
          const float inv = family == 0 ? inv_vv : inv_vs;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) acc[ch] += t[ch] * inv;
        },
        &mats);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) partial[((size_t)chunk * 3 + ch) * B + b] = acc[ch];
  if (COUNT) {
    const uint32_t all[N_COUNTS] = {cnt.fetches,    cnt.boxes,     cnt.tris,
                                    cnt.segments,   n_open[0],     n_open[1],
                                    cnt.need_boxes, cnt.need_tris, cnt.differ};
#pragma unroll
    for (int i = 0; i < N_COUNTS; ++i) atomicAdd(counts + i, (unsigned long long)all[i]);
  }
}

}  // namespace
