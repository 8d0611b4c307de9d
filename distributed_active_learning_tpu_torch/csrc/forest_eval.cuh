// Shared eval body of the forest kernels (forest_leaves.cu,
// round_megakernel.cu, fused_votes.cu; the layout variants
// forest_leaves_transposed.cu and forest_leaves_segmented.cu reuse its
// staging and its popcount), the Hopper counterpart of the JAX package's
// trees_pallas._leaf_rows: for each (row, tree), the leaf value reached when
// every node slot's feature, rounded to bf16, is compared against its f32
// threshold.
//
// Layout. One block owns a tile of ROWS pool rows, one thread per row, and
// walks all trees of the forest itself, so the row tile is read from device
// memory once per kernel (the TPU kernel's sequential tree grid axis becomes
// this in-block loop). The row tile sits in shared memory transposed,
// x_s[feature][row], as bf16: thread r reads x_s[f * ROWS + r], so a warp
// reads 64 consecutive bytes with no bank conflict. Each tree's arrays are
// staged into shared memory in turn; every thread then reads the same word
// at the same time (a broadcast).
//
// Arithmetic. The TPU kernel needed a one-hot selection matmul because its
// matrix unit cannot gather; a GPU thread reads x[row, feat[i]] directly.
// The ancestor-agreement count of leaf l, sum_i path[i, l] * c_i with path in
// {-1, 0, +1}, is computed from two bit masks per leaf column (plus: path ==
// +1, minus: path == -1) and the compare bits c packed 32 to a word:
//   count_l = sum_w popc(c_w & plus_lw) - popc(c_w & minus_lw),
// exactly the int8 product of the TPU kernel. hit = (float(count) == target)
// and the output is sum_l value_l * hit_l, accumulated in ascending leaf order
// (one hit per tree for any valid forest, so the sum is exact). Words whose
// plus and minus masks are both zero add nothing and are skipped through a
// per-leaf word mask (nz), which halves the work for a complete heap tree.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dal {

constexpr int ROWS = 128;   // rows per block, one thread each
constexpr int MAX_W = 8;    // 32-bit words of compare bits: I_pad <= 256

__device__ inline float neg_inf() { return __uint_as_float(0xff800000u); }

struct Forest {
  const int* feat;         // [T, i_pad] feature id per node slot
  const float* thr;        // [T, i_pad] threshold (-inf in padded slots)
  const uint32_t* plus;    // [T, L, W] path == +1 bits
  const uint32_t* minus;   // [T, L, W] path == -1 bits
  const float* tgt;        // [T, L] required count
  const float* val;        // [T, L] leaf value
  int T, i_pad, L, W;
};

struct Smem {
  uint16_t* x;      // [d][ROWS] bf16 bits
  int* feat;        // [i_pad]
  float* thr;       // [i_pad]
  uint32_t* plus;   // [L * W]
  uint32_t* minus;  // [L * W]
  float* tgt;       // [L]
  float* val;       // [L]
  uint32_t* nz;     // [L] words with a nonzero mask
  float* work;      // [ROWS] (megakernel only)
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline size_t smem_bytes(int d, int i_pad, int L, int W) {
  size_t b = align16(size_t(d) * ROWS * sizeof(uint16_t));
  b += align16(size_t(i_pad) * sizeof(int));
  b += align16(size_t(i_pad) * sizeof(float));
  b += 2 * align16(size_t(L) * W * sizeof(uint32_t));
  b += 3 * align16(size_t(L) * sizeof(float));
  b += align16(ROWS * sizeof(float));
  return b;
}

__device__ inline Smem carve(unsigned char* base, int d, int i_pad, int L, int W) {
  Smem s;
  size_t o = 0;
  s.x = reinterpret_cast<uint16_t*>(base + o);     o += align16(size_t(d) * ROWS * sizeof(uint16_t));
  s.feat = reinterpret_cast<int*>(base + o);       o += align16(size_t(i_pad) * sizeof(int));
  s.thr = reinterpret_cast<float*>(base + o);      o += align16(size_t(i_pad) * sizeof(float));
  s.plus = reinterpret_cast<uint32_t*>(base + o);  o += align16(size_t(L) * W * sizeof(uint32_t));
  s.minus = reinterpret_cast<uint32_t*>(base + o); o += align16(size_t(L) * W * sizeof(uint32_t));
  s.tgt = reinterpret_cast<float*>(base + o);      o += align16(size_t(L) * sizeof(float));
  s.val = reinterpret_cast<float*>(base + o);      o += align16(size_t(L) * sizeof(float));
  s.nz = reinterpret_cast<uint32_t*>(base + o);    o += align16(size_t(L) * sizeof(float));
  s.work = reinterpret_cast<float*>(base + o);
  return s;
}

// The block's row tile [base, base + ROWS) x d, rounded to bf16 with
// round-to-nearest-even (as x.astype(bfloat16)). The rows are contiguous in
// x, so the load is one coalesced sweep; rows past n are zero.
__device__ inline void stage_rows(const float* __restrict__ x, int n, int d, int base, Smem s) {
  const int total = ROWS * d;
  const long long start = (long long)base * d;
  const long long limit = (long long)n * d;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const long long g = start + j;
    const float v = g < limit ? x[g] : 0.0f;
    const int r = j / d;
    const int f = j - r * d;
    s.x[f * ROWS + r] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// Tree t's node arrays, path masks, targets and nonzero-word masks; the leaf
// payload is staged by the caller (stage_tree adds the f32 values).
__device__ inline void stage_nodes(const Forest& F, int t, Smem s) {
  const int nw = F.L * F.W;
  for (int i = threadIdx.x; i < F.i_pad; i += blockDim.x) {
    s.feat[i] = F.feat[(size_t)t * F.i_pad + i];
    s.thr[i] = F.thr[(size_t)t * F.i_pad + i];
  }
  for (int j = threadIdx.x; j < nw; j += blockDim.x) {
    s.plus[j] = F.plus[(size_t)t * nw + j];
    s.minus[j] = F.minus[(size_t)t * nw + j];
  }
  for (int l = threadIdx.x; l < F.L; l += blockDim.x) {
    s.tgt[l] = F.tgt[(size_t)t * F.L + l];
    uint32_t m = 0;
    for (int w = 0; w < F.W; ++w) {
      const size_t k = (size_t)t * nw + (size_t)l * F.W + w;
      m |= (uint32_t)((F.plus[k] | F.minus[k]) != 0u) << w;
    }
    s.nz[l] = m;
  }
}

__device__ inline void stage_tree(const Forest& F, int t, Smem s) {
  stage_nodes(F, t, s);
  for (int l = threadIdx.x; l < F.L; l += blockDim.x) {
    s.val[l] = F.val[(size_t)t * F.L + l];
  }
}

// Ancestor-agreement count of leaf l of the staged tree from the compare bits
// c (W <= MAX_W words, held in registers).
__device__ inline int ancestor_count(const Smem& s, int W, int l, const uint32_t (&c)[MAX_W]) {
  const uint32_t nz = s.nz[l];
  const uint32_t* p = s.plus + l * W;
  const uint32_t* m = s.minus + l * W;
  int count = 0;
#pragma unroll
  for (int w = 0; w < MAX_W; ++w) {
    if (nz & (1u << w)) {
      count += __popc(c[w] & p[w]) - __popc(c[w] & m[w]);
    }
  }
  return count;
}

// Leaf value of the staged tree for this thread's row.
__device__ inline float eval_tree(const Forest& F, Smem s) {
  const int r = threadIdx.x;
  uint32_t c[MAX_W];
#pragma unroll
  for (int w = 0; w < MAX_W; ++w) {
    uint32_t bits = 0u;
    if (w < F.W) {
      for (int b = 0; b < 32; ++b) {
        const int i = w * 32 + b;
        const float xv = __uint_as_float((uint32_t)s.x[s.feat[i] * ROWS + r] << 16);
        bits |= (uint32_t)(xv <= s.thr[i]) << b;
      }
    }
    c[w] = bits;
  }
  float acc = 0.0f;
  for (int l = 0; l < F.L; ++l) {
    if ((float)ancestor_count(s, F.W, l, c) == s.tgt[l]) acc += s.val[l];
  }
  return acc;
}

}  // namespace dal
