// The textured form of kernel 7, the VRL sum with BVH occlusion:
// vrl_bvh.cuh's bvh_block with TEX (vrl_sum_bvh.cu's material form,
// vrl_sum_bvh_ext_kernel<.., MAT>, on the textured ray pack), hand-written
// for Hopper (sm_90a); see vrl_tex.cuh. In a source of its own, so that
// vrl_sum_bvh.cu keeps its machine code and the two compile side by side.
//
// Replaces, for a textured table on a large mesh,
// alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_bvh, whose ray pack gives a
// textured hit its untextured base albedo (ROADMAP C25). Plain version:
// ops/vrl_sum_bvh.py vrl_sum_bvh_reference on the textured pack. Bound,
// as kernel 7, by its operations and held back by the latency of each
// shadow traversal (vrl_sum_bvh.cu's header). It takes the extended
// medium pack (the mixture phase, the strategies' rate) as 7m does, and
// keeps its launch bound (BVH_MIN_BLOCKS): the table, the threads' three
// textured rows (30 KB a block) and the far-child stack share the
// block's dynamic shared memory, about 42 KB at the bench's 21-deep
// trees, so five blocks still fit an SM.
// Precise math functions throughout (no --use_fast_math).

#include "vrl_bvh.cuh"

namespace {

// bvh_block<PHASE, SHORT_VRLS, COUNT, true, true, true>: the table, then
// the threads' rows, then the stack in dynamic shared memory.
template <int PHASE, bool SHORT_VRLS, bool COUNT>
__global__ void __launch_bounds__(RAY_BLOCK, BVH_MIN_BLOCKS)
    vrl_sum_bvh_tex_kernel(const float* __restrict__ rays, int B, const float* __restrict__ vrls,
                           int N, const float4* __restrict__ nodes, int n_nodes,
                           const float* __restrict__ tris, const float* __restrict__ med,
                           const float* __restrict__ mat_table, int M,
                           const float* __restrict__ rt, const float* __restrict__ uniforms,
                           uint32_t seed, int svv, int svs, float* __restrict__ partial,
                           unsigned long long* __restrict__ counts) {
  bvh_block<PHASE, SHORT_VRLS, COUNT, true, true, true>(rays, B, vrls, N, nodes, n_nodes, tris,
                                                        med, uniforms, seed, svv, svs, partial,
                                                        counts, mat_table, M, rt);
}

}  // namespace

extern "C" {

// Kernel 7's textured form, with alvrl_vrl_sum_bvh's arguments (its `tex`
// set: `ext` 1 and a table; `counts` selects the counting instantiation).
int alvrl_vrl_sum_bvh_tex(const float* rays, int B, const float* vrls, int N, const float* nodes,
                          int n_nodes, const float* tris, int T, int depth, const float* med,
                          const float* mat_table, int M, const float* rt,
                          const float* uniforms, unsigned int seed, int svv, int svs,
                          int short_vrls, int phase_kind, float* partial, int n_chunks,
                          float* out, unsigned long long* counts, void* stream) {
  if (!bvh_args_ok(B, N, n_nodes, T, depth, svv, svs, n_chunks) ||
      !tex_ok(mat_table, M, rt, 0, nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((B + RAY_BLOCK - 1) / RAY_BLOCK, n_chunks);
  const size_t smem =
      bvh_stack_bytes(depth) + ((size_t)M * MAT_COLS + TEX_SMEM_FLOATS) * sizeof(float);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t attr = cudaSuccess;
  const int d = dispatch<true>(phase_kind, short_vrls, [&](auto phase, auto short_) {
    constexpr int P = decltype(phase)::value;
    constexpr bool S = decltype(short_)::value;
    const auto kernel =
        counts ? &vrl_sum_bvh_tex_kernel<P, S, true> : &vrl_sum_bvh_tex_kernel<P, S, false>;
    attr = allow_smem(kernel, smem);
    if (attr == cudaSuccess)
      kernel<<<blocks, RAY_BLOCK, smem, st>>>(rays, B, vrls, N, nodes4, n_nodes, tris, med,
                                              mat_table, M, rt, uniforms, seed, svv, svs,
                                              partial, counts);
  });
  if (d != 0) return d;
  if (attr != cudaSuccess) return (int)attr;
  return bvh_reduce(partial, n_chunks, B, out, st);
}

}  // extern "C"
