// Gather probes, hand-written for Hopper (sm_90a).
//
// Replace the three pallas_calls of scripts/probe_gather.py:main, which
// asked whether Mosaic's dynamic gather (jnp.take_along_axis inside a
// Pallas kernel) works on the TPU and how fast it is:
//   * alvrl_lane_gather (:42): out[i, j] = tbl[i, idx[i, j]], the gather
//     along a row (the TPU's lane gather from a row-replicated table);
//   * alvrl_row_gather (:63): out[i, j] = tbl[idx[i, j], j], the gather
//     along a column (the TPU's transposed lane gather);
//   * alvrl_gather_many (:79): out[i, j] = sum over k < reps, in k order,
//     of tbl[i, (idx[i, j] + k) % cols]: reps gathers per element.
// tbl and out are (rows, cols) float32, idx (rows, cols) int32 in
// [0, rows) or [0, cols) as the gather's axis needs (the wrapper checks).
// Plain PyTorch twins: scripts/probe_gather.py (torch.take_along_dim).
//
// What bounds them on the H100: at the probe's 128 x 128 shapes the
// first two move 192 KB (a few hundredths of a microsecond at 3.35 TB/s)
// and take a launch's few microseconds; the third does 2^22 gathers and
// adds on 128 KB, its adds bound it. The designs: one thread per element,
// neighbouring threads on neighbouring j (coalesced idx and out, and
// tbl's column reads in the column gather); in the many-gather probe one
// block per row, which stages its row of the table in shared memory (the
// counterpart of the TPU's table in vector registers), so each gather is
// a shared-memory read; each thread adds its gathers in k order, as the
// plain version does, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int PROBE_BLOCK = 256;

__global__ void lane_gather_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                                   int rows, int cols, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  out[e] = tbl[(size_t)(e / cols) * cols + idx[e]];
}

__global__ void row_gather_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                                  int rows, int cols, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  out[e] = tbl[(size_t)idx[e] * cols + e % cols];
}

// one block per row i, blockDim.x threads over its cols columns
__global__ void gather_many_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                                   int cols, int reps, float* __restrict__ out) {
  extern __shared__ float s_row[];
  const size_t row = (size_t)blockIdx.x * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) s_row[j] = tbl[row + j];
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int i0 = idx[row + j];
    float acc = 0.0f;
    for (int k = 0; k < reps; ++k) acc += s_row[(i0 + k) % cols];
    out[row + j] = acc;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = launched) and launches on `stream`.
int alvrl_lane_gather(const float* tbl, const int* idx, int rows, int cols, float* out,
                      void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int n = rows * cols;
  lane_gather_kernel<<<(n + PROBE_BLOCK - 1) / PROBE_BLOCK, PROBE_BLOCK, 0,
                       (cudaStream_t)stream>>>(tbl, idx, rows, cols, out);
  return (int)cudaGetLastError();
}

int alvrl_row_gather(const float* tbl, const int* idx, int rows, int cols, float* out,
                     void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int n = rows * cols;
  row_gather_kernel<<<(n + PROBE_BLOCK - 1) / PROBE_BLOCK, PROBE_BLOCK, 0,
                      (cudaStream_t)stream>>>(tbl, idx, rows, cols, out);
  return (int)cudaGetLastError();
}

int alvrl_gather_many(const float* tbl, const int* idx, int rows, int cols, int reps, float* out,
                      void* stream) {
  if (rows <= 0 || cols <= 0 || reps < 0 || (size_t)cols * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  gather_many_kernel<<<rows, cols < PROBE_BLOCK ? cols : PROBE_BLOCK, cols * sizeof(float),
                       (cudaStream_t)stream>>>(tbl, idx, cols, reps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
