// The round megakernel: forest eval -> hard votes -> acquisition score ->
// per-tile top-k in one pass over the pool. The Hopper port of the JAX
// package's ops/round_fused.py::_mega_kernel (launched by _megakernel there
// and by ops/round_fused.py::_launch_megakernel here).
//
// One block owns ROWS pool rows and walks every tree itself (forest_eval.cuh),
// counting votes leaf > 0.5 in a register, so neither the [n, T] leaf matrix
// nor the score vector ever reaches device memory: that is the point of the
// kernel. After the last tree each row's directed score is
//   work = table[votes] + (selectable ? 0 : -inf),
// where table[v] is the strategy's score of p = v / T computed by the
// wrapper with the port's own scoring functions (votes are integers in
// [0, T], so the score takes only T + 1 values and no transcendental runs
// here). The tile's candidates are ranked exactly: a row's rank is the number
// of rows with a larger score, or an equal score and a lower index, so the
// first kk ranks are the tile's top-kk in lax.top_k's order (value
// descending, index ascending). ops/topk.py::merge_tile_topk merges tiles.
//
// What bounds it on an H100: the function needs depth + 1 compares per
// (row, tree) (the walk and the vote, ~2.6e8 at the benchmark width, a few
// microseconds at the f32 rate) against ~36 MB of input (x once, the
// forest, the mask) and a few KB of output, ~0.011 ms at 3.35 TB/s: bound
// by bytes. Like forest_leaves.cu this kernel does the TPU kernel's
// ancestor counts over every leaf with popcounts on the CUDA cores, so
// integer issue bounds it, far above the byte bound (PERF.md gives the
// measured share); the fusion removes the [T, n] output write.

#include "forest_eval.cuh"

namespace {

__global__ void __launch_bounds__(dal::ROWS) round_megakernel_kernel(
    const float* __restrict__ x, int n, int d, dal::Forest F,
    const unsigned char* __restrict__ selectable, const float* __restrict__ table, int kk,
    float* __restrict__ out_vals, int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dal::Smem s = dal::carve(smem_raw, d, F.i_pad, F.L, F.W);
  const int base = blockIdx.x * dal::ROWS;
  const int r = threadIdx.x;
  const int row = base + r;
  dal::stage_rows(x, n, d, base, s);
  int votes = 0;
  for (int t = 0; t < F.T; ++t) {
    __syncthreads();
    dal::stage_tree(F, t, s);
    __syncthreads();
    votes += dal::eval_tree(F, s) > 0.5f ? 1 : 0;
  }
  float w = dal::neg_inf();  // padding rows past n are never selectable
  if (row < n) {
    const float pen = selectable[row] ? 0.0f : dal::neg_inf();
    w = table[votes] + pen;
  }
  s.work[r] = w;
  __syncthreads();
  int rank = 0;
  for (int j = 0; j < dal::ROWS; ++j) {
    const float o = s.work[j];
    rank += (o > w || (o == w && j < r)) ? 1 : 0;
  }
  if (rank < kk) {
    out_vals[(size_t)blockIdx.x * kk + rank] = w;
    out_idx[(size_t)blockIdx.x * kk + rank] = row;
  }
}

}  // namespace

extern "C" int round_megakernel(
    const float* x, int n, int d,
    const int* feat, const float* thr, const uint32_t* plus, const uint32_t* minus,
    const float* tgt, const float* val, int T, int i_pad, int L,
    const unsigned char* selectable, const float* table, int kk,
    float* out_vals, int* out_idx, void* stream) {
  const int W = i_pad / 32;
  if (W < 1 || W > dal::MAX_W || i_pad % 32 != 0 || n <= 0 || d <= 0 || T <= 0 || L <= 0 ||
      kk < 1 || kk > dal::ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  dal::Forest F{feat, thr, plus, minus, tgt, val, T, i_pad, L, W};
  const size_t smem = dal::smem_bytes(d, i_pad, L, W);
  cudaError_t err = cudaFuncSetAttribute(
      round_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + dal::ROWS - 1) / dal::ROWS;
  round_megakernel_kernel<<<blocks, dal::ROWS, smem, (cudaStream_t)stream>>>(
      x, n, d, F, selectable, table, kk, out_vals, out_idx);
  return (int)cudaGetLastError();
}
