// VRL x eye-ray sum with BVH occlusion, hand-written for Hopper (sm_90a).
//
// Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_bvh (:1415; its
// occlusion _occl_bvh, :1175): kernel 1's function (vrl_sum.cu: for each
// eye ray b the sum over the valid VRLs of the vol-vol and vol-surf
// estimators, (3, B) float32, not normalised by the particle count) with
// no cap on the triangle count. Entry point alvrl_vrl_sum_bvh; plain
// PyTorch twin ops/vrl_sum_bvh.py:vrl_sum_bvh_reference. Homogeneous
// media only, as the TPU kernel. Its extended forms
// (vrl_sum_bvh_ext_kernel, the entry's ext 1) read the medium
// pack with its extension (a strategy other than balance; PHASE 2, the
// mixture) and, MAT, a material table (the eye hit's smooth BSDF), as
// kernel 1 does, which the JAX package's XLA route computes and its
// Pallas kernel does not (ROADMAP C16, C21); the forms on the plain pack
// are unchanged.
//
// What bounds it on the H100: by its operations, fp32 ALU throughput
// (per pair-sample the estimator's, about 150 float32 and 20
// special-function operations; per shadow segment 19 operations per
// node box and 59 per triangle tested, chip_smoke.py's OPS, a number of
// each that depends on the data, which the counting instantiation
// (COUNT=true) measures). The nodes and triangles (64 and 36 bytes each:
// about 9 MB at 129,612 triangles) stay resident in the 50 MB L2. What
// holds it back is latency: each shadow segment walks its own path
// through the tree, and each step of that walk is a read that depends
// on the one before. The TPU kernel streamed 64-triangle leaf clusters
// from HBM behind per-ray-group AABB culling, because its scalar core
// could not chase pointers per ray; on Hopper each thread walks its own
// segment, and the design shortens that chain and hides its latency:
//   * the grid: ray tiles (RAY_BLOCK threads, one ray each) x chunks of
//     BVH_VRL_CHUNK VRLs (one VRL a block, not kernel 1's 32), so that
//     the bench launch (4,096 rays x 256 VRLs) makes 8,192 blocks
//     instead of 256: every SM has warps to switch between, and a block,
//     which lasts as long as its slowest traversals, holds few of them
//     (measured faster than chunks of 2-32 on every bench scene on an
//     H100, PERF.md); the chunk's VRL is staged in shared memory, the
//     Philox counter (b, n, j) is kernel 1's, and the (n_chunks, 3, B)
//     partial sums are added in chunk order by reduce_parts
//     (deterministic);
//   * the nodes: each node holds both children's boxes and references
//     (64 bytes, four float4s), so one dependent fetch tests two boxes,
//     and the children of an inner node are found without a fetch of
//     their own;
//   * the traversal: Aila and Laine's "while-while" (Understanding the
//     efficiency of ray traversal on GPUs, HPG 2009) for an any-hit
//     test: the inner loop tests both children of a node, descends into
//     the nearer overlapping one without a push, pushes the other only
//     when both overlap, and postpones a leaf until every lane of the
//     warp holds one; the leaf loop tests the leaves' triangles and
//     exits at the first blocker;
//   * the stack: only far children are pushed, so a tree of depth d
//     needs at most d entries; each thread keeps d of them in its own
//     column of the block's dynamic shared memory (no local-memory
//     array; 10.5 KB a block for the bench's 21-deep trees), and the
//     host refuses a tree deeper than BVH_STACK
//     (ops/vrl_sum_bvh.py:pack_bvh_tris), as the entry point does;
//   * the box test is a slab test with IEEE infinities for zero
//     direction components (the near and far planes picked by the sign,
//     min/max that ignore the NaN of a segment lying in a box's face);
//     every box is padded outward (ops/vrl_sum_bvh.py:BOX_PAD), and each
//     triangle goes through vrl_common.cuh's wald_hit, the function of
//     kernel 1's flat sweep, so the traversal finds every triangle the
//     sweep finds: both kernels make the same shadow decisions;
//   * the 32 rays of a warp share a VRL at each loop step, but their
//     segments differ, so the traversals diverge; the counting
//     instantiation writes down node fetches, box and triangle tests per
//     segment, and beside them the work the shadow function needs (the
//     box and triangle tests of a one-box-per-node traversal in child
//     order, which stops at its first blocker: needed_work), which
//     prices the bound (PERF.md).
// Precise math functions throughout (no --use_fast_math).

#include "vrl_bvh.cuh"

namespace {

// Kernel 7 on the medium pack (MED_LEN,): HG or Rayleigh, balance,
// diffuse surfaces...
template <int PHASE, bool SHORT_VRLS, bool COUNT>
__global__ void __launch_bounds__(RAY_BLOCK, BVH_MIN_BLOCKS)
    vrl_sum_bvh_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                       int N, const float4* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ tris, const float* __restrict__ med,
                       const float* __restrict__ uniforms, uint32_t seed, int svv, int svs,
                       float* __restrict__ partial, unsigned long long* __restrict__ counts) {
  bvh_block<PHASE, SHORT_VRLS, COUNT, false, false>(rays, B, vrls, N, nodes, n_nodes, tris, med,
                                                    uniforms, seed, svv, svs, partial, counts);
}

// ...and its forms on the extended medium pack (a strategy other than
// balance; PHASE 2, the mixture) and, MAT, on a material table (glossy
// and layered surfaces: the eye hit's smooth BSDF, vrl_common.cuh
// eval_smooth), under the same launch bound.
template <int PHASE, bool SHORT_VRLS, bool COUNT, bool MAT>
__global__ void __launch_bounds__(RAY_BLOCK, BVH_MIN_BLOCKS)
    vrl_sum_bvh_ext_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                           int N, const float4* __restrict__ nodes, int n_nodes,
                           const float* __restrict__ tris, const float* __restrict__ med,
                           const float* __restrict__ mat_table, int M,
                           const float* __restrict__ rt, const float* __restrict__ uniforms,
                           uint32_t seed, int svv, int svs, float* __restrict__ partial,
                           unsigned long long* __restrict__ counts) {
  bvh_block<PHASE, SHORT_VRLS, COUNT, true, MAT>(rays, B, vrls, N, nodes, n_nodes, tris, med,
                                                 uniforms, seed, svv, svs, partial, counts,
                                                 mat_table, M, rt);
}


}  // namespace

extern "C" {

int alvrl_bvh_stack() { return BVH_STACK; }

// The BVH-occlusion sum. nodes (n_nodes, 16) and tris (T, TRI_COLS) are
// ops/vrl_sum_bvh.py:pack_bvh_tris' pack, depth its tree's depth (edges
// from the root to the deepest leaf), partial (n_chunks, 3, B) with
// n_chunks = ceil(N / BVH_VRL_CHUNK); ext 1: the extended forms, on the
// extended medium pack (ops/pack.py pack_medium: MED_LEN + 2 + 3 K
// floats; phase_kind 0, 1 or 4, the mixture of the extension's K
// components), and with mat_table (M, MAT_COLS), M and rt (M, RT_COS,
// RT_ALPHA) their material form, whose rays carry the hit's material id
// in row MATID; ext 0: the forms on the (MED_LEN,) pack, phase_kind 0 or
// 1 and no table (null, 0, null); tex 1 (ext 1, with a table): the
// textured form (vrl_sum_bvh_tex.cu), whose rays are the textured pack;
// the rest as alvrl_vrl_sum. `counts`,
// when not null, selects the counting instantiation and receives
// N_COUNTS totals (zeroed by the caller). Returns a cudaError_t (0 =
// launched).
int alvrl_vrl_sum_bvh(const float* rays, int B, const float* vrls, int N, const float* nodes,
                      int n_nodes, const float* tris, int T, int depth, const float* med, int ext,
                      const float* mat_table, int M, const float* rt, int tex,
                      const float* uniforms, unsigned int seed, int svv, int svs, int short_vrls,
                      int phase_kind, float* partial, int n_chunks, float* out,
                      unsigned long long* counts, void* stream) {
  if (tex) {
    if (!ext) return (int)cudaErrorInvalidValue;
    return alvrl_vrl_sum_bvh_tex(rays, B, vrls, N, nodes, n_nodes, tris, T, depth, med,
                                 mat_table, M, rt, uniforms, seed, svv, svs, short_vrls,
                                 phase_kind, partial, n_chunks, out, counts, stream);
  }
  if (!bvh_args_ok(B, N, n_nodes, T, depth, svv, svs, n_chunks) || !mats_ok(mat_table, M, rt) ||
      (!ext && M > 0))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem = bvh_stack_bytes(depth) + (size_t)M * MAT_COLS * sizeof(float);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t attr = cudaSuccess;
  const int d =
      ext ? dispatch<true>(phase_kind, short_vrls,
                           [&](auto phase, auto short_) {
                             constexpr int P = decltype(phase)::value;
                             constexpr bool S = decltype(short_)::value;
                             auto kernel =
                                 counts ? (M > 0 ? &vrl_sum_bvh_ext_kernel<P, S, true, true>
                                                 : &vrl_sum_bvh_ext_kernel<P, S, true, false>)
                                        : (M > 0 ? &vrl_sum_bvh_ext_kernel<P, S, false, true>
                                                 : &vrl_sum_bvh_ext_kernel<P, S, false, false>);
                             attr = allow_smem(kernel, smem);
                             if (attr == cudaSuccess)
                               kernel<<<blocks, RAY_BLOCK, smem, st>>>(
                                   rays, B, vrls, N, nodes4, n_nodes, tris, med, mat_table, M,
                                   rt, uniforms, seed, svv, svs, partial, counts);
                           })
          : dispatch(phase_kind, short_vrls, [&](auto phase, auto short_) {
              constexpr int P = decltype(phase)::value;
              constexpr bool S = decltype(short_)::value;
              if (counts)
                vrl_sum_bvh_kernel<P, S, true><<<blocks, RAY_BLOCK, smem, st>>>(
                    rays, B, vrls, N, nodes4, n_nodes, tris, med, uniforms, seed, svv, svs,
                    partial, counts);
              else
                vrl_sum_bvh_kernel<P, S, false><<<blocks, RAY_BLOCK, smem, st>>>(
                    rays, B, vrls, N, nodes4, n_nodes, tris, med, uniforms, seed, svv, svs,
                    partial, nullptr);
            });
  if (d != 0) return d;
  if (attr != cudaSuccess) return (int)attr;
  return bvh_reduce(partial, n_chunks, B, out, st);
}

}  // extern "C"
