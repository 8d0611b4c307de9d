// Per-tree leaf values from the feature-major pool: the Hopper port of the
// kernel-variant sweep's benches/pallas_variants.py::_kernel_transposed,
// launched by benches/pallas_variants.py::_launch_transposed of the port.
//
// The function is forest_leaves.cu's (the leaf a row's bf16 features reach
// in each tree of a complete heap forest) with the sweep's layout and knobs:
//   - x arrives transposed, xT[d_pad][n_pad] in bf16;
//   - the output is tree-major, out[T][n];
//   - the grid is (row tiles of bn rows) x (tree tiles of bt trees), a block
//     per pair; tree_outer puts the tree tile in the slow grid dimension, so
//     consecutive blocks share a tree tile and sweep the rows;
//   - the leaf payload is the exact f32 value (leaf_f32) or the sum of its two
//     bf16 planes hi + lo in f32, as the TPU kernel's [2, L] x [L, bn]
//     product gives it;
//   - ablate stops after a stage and writes that stage's intermediate per
//     tree: sel (the bf16 feature of node 0, the root), cmp (its compare),
//     main (leaf 0's ancestor-agreement count: the true compares on the left
//     spine), eq (whether that count equals leaf 0's target, the depth).
//
// The TPU kernel counted ancestors over every leaf through a one-hot
// selection product and a path matrix, because its matrix unit cannot
// gather. Here each row walks from the root (heap_tiles.cuh, on
// heap_walk.cuh): depth compares a (row, tree) in place of 2^depth leaf
// counts. The block stages its tile's trees as K1's heap words (the
// wrapper packs them with trees_pallas.heap_operands, and refuses a forest
// that is not made of complete heap trees) and the leaf payloads as 4-byte
// words beside them. What bounds it: the bytes it must move (heap_tiles.cuh).

#include "heap_tiles.cuh"

namespace {

__global__ void __launch_bounds__(ht::THREADS) forest_leaves_transposed_kernel(
    ht::Tiles P, const int2* __restrict__ nodes, const float* __restrict__ val,
    const uint16_t* __restrict__ hi, const uint16_t* __restrict__ lo) {
  ht::walk_tiles(P, [&](int c0, int nt, int2* nodes_s, uint32_t* pay_s) {
    const int2* src = nodes + (size_t)c0 * P.N;
    for (int j = threadIdx.x; j < nt * P.N; j += blockDim.x) nodes_s[j] = src[j];
    for (int j = threadIdx.x; j < nt * P.L; j += blockDim.x) {
      const size_t k = (size_t)c0 * P.L + j;
      pay_s[j] = P.leaf_f32 ? __float_as_uint(val[k]) : (uint32_t)hi[k] | ((uint32_t)lo[k] << 16);
    }
  });
}

}  // namespace

// xT [d_pad, n_pad] bf16; nodes [>= T, N] heap words; the payload val [>= T,
// 2^depth] f32 (leaf_f32) or hi and lo [>= T, 2^depth] bf16; out [T, n].
extern "C" int forest_leaves_transposed(
    const uint16_t* xT, int n, int n_pad, int d_pad, const int2* nodes, const float* val,
    const uint16_t* hi, const uint16_t* lo, int T, int depth, int N, int bn, int bt,
    int tree_outer, int leaf_f32, int ablate, float* out, void* stream) {
  const int L = depth >= 0 && depth <= heap::MAX_DEPTH ? 1 << depth : 0;
  ht::Tiles P{xT, out, n, n_pad, d_pad, T, bn, bt, tree_outer, depth, N, L,
              0, 0, leaf_f32, ablate};
  unsigned blocks = 0;
  cudaError_t err = ht::grid_of(P, &blocks);
  if (err != cudaSuccess || ablate < ht::FULL || ablate > ht::EQ ||
      (leaf_f32 ? val == nullptr : (hi == nullptr || lo == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  if ((err = ht::plan(d_pad, N, P.L, bt, &P.rows, &P.ct, &smem)) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(forest_leaves_transposed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  forest_leaves_transposed_kernel<<<blocks, ht::THREADS, smem, (cudaStream_t)stream>>>(
      P, nodes, val, hi, lo);
  return (int)cudaGetLastError();
}
