// Per-tree leaf values from the feature-major pool: the Hopper port of the
// kernel-variant sweep's benches/pallas_variants.py::_kernel_transposed,
// launched by benches/pallas_variants.py::_launch_transposed of the port.
//
// The function is forest_leaves.cu's (bf16 features against f32 thresholds,
// ancestor counts, hit, leaf payload) with the sweep's layout and knobs:
//   - x arrives transposed, xT[d_pad][n_pad] in bf16, so a warp's 32 rows read
//     64 consecutive bytes per feature and no f32 row tile is staged;
//   - the output is tree-major, out[T][n];
//   - the grid is (row tiles of bn rows) x (tree tiles of bt trees), a block
//     per pair; tree_outer puts the tree tile in the slow grid dimension, so
//     consecutive blocks share a tree tile and sweep the rows;
//   - the leaf payload is the exact f32 value (leaf_f32) or the sum of its two
//     bf16 planes hi + lo, each accumulated over the hits and then added, as
//     the TPU kernel's [2, L] x [L, bn] product does;
//   - ablate stops after a stage and writes row 0 of that stage's
//     intermediate per tree: sel (the bf16 feature of node slot 0), cmp (its
//     compare), main (the ancestor count of leaf 0), eq (leaf 0's hit).
//
// One thread owns a row at a time (128 threads sweep the tile's bn rows); the
// block stages one tree of its tile after the other into shared memory
// (forest_eval.cuh's staging and popcount). What bounds it: as forest_leaves.cu,
// the popcounts over all leaves of every tree, far above the bytes it moves.

#include "forest_eval.cuh"

namespace {

enum Ablate { FULL = 0, SEL = 1, CMP = 2, MAIN = 3, EQ = 4 };

struct Tile {
  int n, n_pad, bn, bt, tree_outer, leaf_f32, ablate;
};

__device__ inline float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__global__ void __launch_bounds__(dal::ROWS) forest_leaves_transposed_kernel(
    const uint16_t* __restrict__ xT, Tile P, dal::Forest F,
    const uint16_t* __restrict__ hi, const uint16_t* __restrict__ lo, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dal::Smem s = dal::carve(smem_raw, 0, F.i_pad, F.L, F.W);
  float* vlo = reinterpret_cast<float*>(smem_raw + dal::smem_bytes(0, F.i_pad, F.L, F.W));
  float* vhi = s.val;

  const int row_tiles = P.n_pad / P.bn;
  const int tree_tiles = (F.T + P.bt - 1) / P.bt;
  const int b = blockIdx.x;
  const int ti = P.tree_outer ? b / row_tiles : b % tree_tiles;
  const int ri = P.tree_outer ? b % row_tiles : b / tree_tiles;
  const int row0 = ri * P.bn;

  for (int tt = 0; tt < P.bt; ++tt) {
    const int t = ti * P.bt + tt;
    if (t >= F.T) break;  // the padded trees of the last tile give no output
    __syncthreads();
    dal::stage_nodes(F, t, s);
    for (int l = threadIdx.x; l < F.L; l += blockDim.x) {
      const size_t k = (size_t)t * F.L + l;
      vhi[l] = P.leaf_f32 ? F.val[k] : bf16_bits_to_float(hi[k]);
      vlo[l] = P.leaf_f32 ? 0.0f : bf16_bits_to_float(lo[k]);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < P.bn; r += blockDim.x) {
      const int row = row0 + r;
      if (row >= P.n) break;
      float res;
      if (P.ablate == SEL || P.ablate == CMP) {
        const float xv = bf16_bits_to_float(xT[(size_t)s.feat[0] * P.n_pad + row]);
        res = P.ablate == SEL ? xv : (xv <= s.thr[0] ? 1.0f : 0.0f);
      } else {
        uint32_t c[dal::MAX_W];
#pragma unroll
        for (int w = 0; w < dal::MAX_W; ++w) {
          uint32_t bits = 0u;
          if (w < F.W) {
            for (int bb = 0; bb < 32; ++bb) {
              const int i = w * 32 + bb;
              const float xv = bf16_bits_to_float(xT[(size_t)s.feat[i] * P.n_pad + row]);
              bits |= (uint32_t)(xv <= s.thr[i]) << bb;
            }
          }
          c[w] = bits;
        }
        if (P.ablate == MAIN) {
          res = (float)dal::ancestor_count(s, F.W, 0, c);
        } else if (P.ablate == EQ) {
          res = (float)dal::ancestor_count(s, F.W, 0, c) == s.tgt[0] ? 1.0f : 0.0f;
        } else {
          float acc_hi = 0.0f, acc_lo = 0.0f;
          for (int l = 0; l < F.L; ++l) {
            if ((float)dal::ancestor_count(s, F.W, l, c) == s.tgt[l]) {
              acc_hi += vhi[l];
              acc_lo += vlo[l];
            }
          }
          res = acc_hi + acc_lo;
        }
      }
      out[(size_t)t * P.n + row] = res;
    }
  }
}

}  // namespace

extern "C" int forest_leaves_transposed(
    const uint16_t* xT, int n, int n_pad,
    const int* feat, const float* thr, const uint32_t* plus, const uint32_t* minus,
    const float* tgt, const float* val, const uint16_t* hi, const uint16_t* lo,
    int T, int i_pad, int L, int bn, int bt, int tree_outer, int leaf_f32, int ablate,
    float* out, void* stream) {
  const int W = i_pad / 32;
  if (W < 1 || W > dal::MAX_W || i_pad % 32 != 0 || n <= 0 || T <= 0 || L <= 0 || bn <= 0 ||
      bt <= 0 || n_pad % bn != 0 || n_pad < n || ablate < FULL || ablate > EQ ||
      (leaf_f32 ? val == nullptr : (hi == nullptr || lo == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  dal::Forest F{feat, thr, plus, minus, tgt, val, T, i_pad, L, W};
  Tile P{n, n_pad, bn, bt, tree_outer, leaf_f32, ablate};
  const size_t smem = dal::smem_bytes(0, i_pad, L, W) + dal::align16(size_t(L) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      forest_leaves_transposed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)(n_pad / bn) * ((T + bt - 1) / bt);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  forest_leaves_transposed_kernel<<<(unsigned)blocks, dal::ROWS, smem, (cudaStream_t)stream>>>(
      xT, P, F, hi, lo, out);
  return (int)cudaGetLastError();
}
