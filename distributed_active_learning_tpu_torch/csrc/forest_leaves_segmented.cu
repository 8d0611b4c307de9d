// Per-tree leaf values with feature-segmented node slots: the Hopper port of
// the kernel-variant sweep's benches/pallas_variants.py::_kernel_segmented,
// launched by benches/pallas_variants.py::_launch_segmented of the port.
//
// The function is forest_leaves.cu's with another operand layout: the node of
// tree t that is the r-th to split on feature f lives at slot k = f * S + r
// (S slots per feature, 32 features, so 32 S slots), and slot k compares
// feature k / S of the row against thr[t][k]: there is no feature-id array.
// Only nodes whose threshold is above -inf have a slot, so a node whose
// threshold is -inf or NaN sends every row right, a -inf feature too (K1
// and K5 send a -inf feature left at a -inf threshold). The leaf payload is
// hi + lo, two bf16 planes added in f32. x arrives transposed, xT[32][n_pad]
// in bf16; the output is tree-major, out[T][n]; the grid is (row tiles of bn
// rows) x (tree tiles of bt trees), the row tile slow.
//
// The TPU kernel counted ancestors over every leaf against the compares of
// all 32 S slots. Here each row walks from the root (heap_tiles.cuh, on
// heap_walk.cuh): depth compares a (row, tree). The block builds each
// staged tree's heap words from its slots as it stages them: node v's slot
// k = slot_of[t][v] gives the word (k / S, thr[t][k]), and a node with no
// slot (k < 0) the word (0, NaN), which compares false for every row. The
// slot map is packed once per forest on the host, beside the slots (the
// wrapper refuses a forest that is not made of complete heap trees). S
// enters only the slot arithmetic: no array of 32 S entries is staged, so
// nothing bounds S but the tree (S <= 2^depth - 1, rounded up to 4). What
// bounds it: the bytes it must move (heap_tiles.cuh).

#include "heap_tiles.cuh"

namespace {

constexpr int SEG_FEATURES = 32;

__global__ void __launch_bounds__(ht::THREADS) forest_leaves_segmented_kernel(
    ht::Tiles P, const int* __restrict__ slot_of, const float* __restrict__ thr, int S,
    const uint16_t* __restrict__ hi, const uint16_t* __restrict__ lo) {
  ht::walk_tiles(P, [&](int c0, int nt, int2* nodes_s, uint32_t* pay_s) {
    const int I = P.L - 1;
    for (int j = threadIdx.x; j < nt * I; j += blockDim.x) {
      const int t = j / I;
      const int v = j - t * I;
      const int k = slot_of[(size_t)c0 * I + j];
      nodes_s[t * P.N + v] =
          k < 0 ? make_int2(0, 0x7fc00000)
                : make_int2(k / S, __float_as_int(thr[(size_t)(c0 + t) * SEG_FEATURES * S + k]));
    }
    for (int j = threadIdx.x; j < nt * P.L; j += blockDim.x) {
      const size_t k = (size_t)c0 * P.L + j;
      pay_s[j] = (uint32_t)hi[k] | ((uint32_t)lo[k] << 16);
    }
  });
}

}  // namespace

// xT [32, n_pad] bf16; slot_of [>= T, 2^depth - 1] int32 (-1: no slot);
// thr [>= T, 32 S] f32; hi and lo [>= T, 2^depth] bf16; out [T, n].
extern "C" int forest_leaves_segmented(
    const uint16_t* xT, int n, int n_pad, const int* slot_of, const float* thr,
    const uint16_t* hi, const uint16_t* lo, int T, int depth, int S, int bn, int bt,
    float* out, void* stream) {
  const int L = depth >= 0 && depth <= heap::MAX_DEPTH ? 1 << depth : 0;
  ht::Tiles P{xT, out, n, n_pad, SEG_FEATURES, T, bn, bt, 0, depth, L < 2 ? 2 : L, L,
              0, 0, 0, ht::FULL};
  unsigned blocks = 0;
  cudaError_t err = ht::grid_of(P, &blocks);
  if (err != cudaSuccess || S < 1 || (long long)SEG_FEATURES * S > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  if ((err = ht::plan(P.d_pad, P.N, L, bt, &P.rows, &P.ct, &smem)) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(forest_leaves_segmented_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  forest_leaves_segmented_kernel<<<blocks, ht::THREADS, smem, (cudaStream_t)stream>>>(
      P, slot_of, thr, S, hi, lo);
  return (int)cudaGetLastError();
}
