// Per-tree leaf values of a path-matrix forest: the Hopper port of the JAX
// package's ops/trees_pallas.py::_kernel (body _leaf_rows), launched by
// predict_leaves_pallas there and by ops/trees_pallas.py::_launch_leaves here.
//
// out[t, row] = sum_l value[t, l] * [count_l(row, t) == target[t, l]], with
// the features compared as bf16 against f32 thresholds (forest_eval.cuh).
//
// What bounds it on an H100. The function needs one compare per level of a
// row's root-to-leaf path: n * T * depth = 2.3e8 compares at the benchmark
// width (284,807 rows, 100 trees, depth 8), ~3.4 us at the f32 rate of the
// CUDA cores, while the bytes it must move (x once, the forest once, the
// [T, n] f32 output once: ~150 MB) take ~0.045 ms at 3.35 TB/s. So the
// function is bound by bytes. This kernel does far more work than that: it
// keeps the TPU kernel's ancestor counts over all 256 leaves of every tree,
// counted with 32-bit popcounts on the CUDA cores (skipping mask words that
// are zero), so integer issue bounds it, at a fraction of a percent of the
// byte bound (PERF.md gives the measured share). What the design does about
// it: the row tile is loaded once and kept in shared memory across all
// trees, each tree's masks are staged once per block and read as broadcasts,
// and only the [T, n] output is written. A heap walk (depth compares per row
// and tree) is the next step.

#include "forest_eval.cuh"

namespace {

__global__ void __launch_bounds__(dal::ROWS) forest_leaves_kernel(
    const float* __restrict__ x, int n, int d, dal::Forest F, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dal::Smem s = dal::carve(smem_raw, d, F.i_pad, F.L, F.W);
  const int base = blockIdx.x * dal::ROWS;
  const int row = base + threadIdx.x;
  dal::stage_rows(x, n, d, base, s);
  for (int t = 0; t < F.T; ++t) {
    __syncthreads();
    dal::stage_tree(F, t, s);
    __syncthreads();
    const float leaf = dal::eval_tree(F, s);
    if (row < n) out[(size_t)t * n + row] = leaf;
  }
}

}  // namespace

extern "C" int forest_leaves(
    const float* x, int n, int d,
    const int* feat, const float* thr, const uint32_t* plus, const uint32_t* minus,
    const float* tgt, const float* val, int T, int i_pad, int L,
    float* out, void* stream) {
  const int W = i_pad / 32;
  if (W < 1 || W > dal::MAX_W || i_pad % 32 != 0 || n <= 0 || d <= 0 || T <= 0 || L <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  dal::Forest F{feat, thr, plus, minus, tgt, val, T, i_pad, L, W};
  const size_t smem = dal::smem_bytes(d, i_pad, L, W);
  cudaError_t err = cudaFuncSetAttribute(
      forest_leaves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + dal::ROWS - 1) / dal::ROWS;
  forest_leaves_kernel<<<blocks, dal::ROWS, smem, (cudaStream_t)stream>>>(x, n, d, F, out);
  return (int)cudaGetLastError();
}
