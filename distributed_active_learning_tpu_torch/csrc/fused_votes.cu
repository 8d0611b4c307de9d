// Hard vote counts of a forest shard: the Hopper port of the JAX package's
// ops/round_fused.py::_votes_kernel (launched by fused_votes_pallas there, by
// ops/round_fused.py::_launch_votes here). It is the per-shard body of the
// mesh's fused round: each (data, model) shard counts the votes of its tree
// shard over its row block, and a sum over the model axis completes them.
//
//   votes[row] = sum_t [leaf_t(row) > 0.5]
//
// One block owns ROWS pool rows and walks every tree of the shard itself
// (forest_eval.cuh), adding each vote to a register, so the [n, T] leaf
// matrix never reaches device memory: that is the point of the TPU kernel,
// which accumulated tree tile by tree tile into a revisited VMEM output.
// Votes are integers, so every route (this kernel, its plain version, the
// gemm branch past the tile limits) agrees bit for bit.
//
// What bounds it on an H100: the function needs depth + 1 compares per
// (row, tree) (the walk and the vote: 3.2e7 for one 71,202-row x 50-tree
// shard of the benchmark pool, under a microsecond at the data sheet's f32
// rate) against the bytes it must move (the row block once, the forest
// shard, the [n] int32 output: ~9.9 MB, 2.9 us at 3.35 TB/s), so it is
// bound by bytes (chip_smoke.py phase 5 computes the bound). Like
// forest_leaves.cu it keeps the TPU kernel's ancestor counts over every leaf
// with popcounts on the CUDA cores, so integer issue bounds it far above that
// (PERF.md gives the measured share); its design keeps the row tile in
// shared memory across all trees and writes 4 bytes per row.

#include "forest_eval.cuh"

namespace {

__global__ void __launch_bounds__(dal::ROWS) fused_votes_kernel(
    const float* __restrict__ x, int n, int d, dal::Forest F, int* __restrict__ votes_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dal::Smem s = dal::carve(smem_raw, d, F.i_pad, F.L, F.W);
  const int base = blockIdx.x * dal::ROWS;
  const int row = base + threadIdx.x;
  dal::stage_rows(x, n, d, base, s);
  int votes = 0;
  for (int t = 0; t < F.T; ++t) {
    __syncthreads();
    dal::stage_tree(F, t, s);
    __syncthreads();
    votes += dal::eval_tree(F, s) > 0.5f ? 1 : 0;
  }
  if (row < n) votes_out[row] = votes;
}

}  // namespace

extern "C" int fused_votes(
    const float* x, int n, int d,
    const int* feat, const float* thr, const uint32_t* plus, const uint32_t* minus,
    const float* tgt, const float* val, int T, int i_pad, int L,
    int* votes, void* stream) {
  const int W = i_pad / 32;
  if (W < 1 || W > dal::MAX_W || i_pad % 32 != 0 || n <= 0 || d <= 0 || T <= 0 || L <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  dal::Forest F{feat, thr, plus, minus, tgt, val, T, i_pad, L, W};
  const size_t smem = dal::smem_bytes(d, i_pad, L, W);
  cudaError_t err = cudaFuncSetAttribute(
      fused_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + dal::ROWS - 1) / dal::ROWS;
  fused_votes_kernel<<<blocks, dal::ROWS, smem, (cudaStream_t)stream>>>(x, n, d, F, votes);
  return (int)cudaGetLastError();
}
