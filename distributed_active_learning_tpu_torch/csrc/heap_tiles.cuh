// The tiled heap walk of the layout-variant kernels K5
// (forest_leaves_transposed.cu) and K6 (forest_leaves_segmented.cu): for
// each (row, tree) of a forest of complete heap trees, the leaf that the
// row's features, rounded to bf16, reach under <= against f32 thresholds
// (heap_walk.cuh's walk), on the variant sweep's layout: x arrives
// feature-major, xT[d_pad][n_pad] in bf16, and the output is tree-major,
// out[T][n] in f32.
//
// The grid is the sweep's: (row tiles of bn rows) x (tree tiles of bt
// trees), one block a pair, the tree tile in the slow grid dimension when
// tree_outer is set. Trees of the last tile past T write nothing.
//
// A block of 256 threads:
// - stages its tile's trees into shared memory in chunks of ct trees (all bt
//   at once while they fit the chunk budget): each node one 8-byte
//   (feature, threshold bits) word in heap order, as K1 reads it, and each
//   leaf's payload one 4-byte word. The kernel's stager builds both: K5
//   copies K1's heap words, K6 derives them from its feature slots;
// - passes the tile's bn rows through shared memory in sub-tiles of R rows
//   (256, or fewer for wide rows, so that a sub-tile stays within 64 KB),
//   bf16 [feature][column]. A 4-byte word pairs rows j and j + R / 2, so
//   the 32 lanes of a warp read 32 distinct words whatever features their
//   walks ask for, and the staging moves 16 bytes a load and a store; a
//   gather from xT in device memory would touch up to 32 sectors a warp
//   load at the deep levels;
// - splits its threads into 256 / R groups of R: thread r of group g owns
//   row r of the sub-tile and walks batches g, g + groups, ... of four trees
//   of the chunk at once (heap::walk<4>), so the dependent shared-memory
//   loads of one walk hide behind the others'. A warp stores 32 consecutive
//   rows of one tree: 128 contiguous bytes.
//
// What bounds it on an H100: the bytes it must move (xT once, the [T, n]
// f32 output once, the forest in its heap form) take ~0.04 ms at the
// benchmark width, the compares (one a tree level) ~3.4 us; the walk's two
// dependent shared-memory loads a level are what K1, K2 and K3 are bound by
// in practice (PERF.md).

#pragma once

#include "heap_walk.cuh"

namespace ht {

constexpr int THREADS = 256;               // threads a block
constexpr int TREE_ILP = 4;                // trees walked at once by a thread
constexpr int ROW_TILE_BYTES = 64 * 1024;  // bf16 row sub-tile budget
constexpr int CHUNK_BYTES = 40 * 1024;     // one chunk of trees: nodes and payloads
constexpr size_t MAX_SMEM = 227 * 1024;    // what a block may ask for

// K5's ablation stages; K6 runs FULL only.
enum Ablate { FULL = 0, SEL = 1, CMP = 2, MAIN = 3, EQ = 4 };

struct Tiles {
  const uint16_t* xT;  // [d_pad, n_pad] bf16 bits
  float* out;          // [T, n]
  int n, n_pad, d_pad, T, bn, bt, tree_outer;
  int depth, N, L;     // heap depth, node words a tree (>= 2^depth), leaves a tree
  int rows, ct;        // rows of a sub-tile, trees of a chunk
  int leaf_f32, ablate;
};

// Rows of a sub-tile, trees of a chunk and the shared memory of a block for
// rows of d_pad features and bt trees of N node words and L leaves.
inline cudaError_t plan(int d_pad, int N, int L, int bt, int* rows, int* ct, size_t* smem) {
  int r = THREADS;
  while (r > 64 && size_t(r) * d_pad * 2 > ROW_TILE_BYTES) r /= 2;
  if (d_pad < 1 || size_t(r) * d_pad * 2 > ROW_TILE_BYTES) return cudaErrorInvalidValue;
  const size_t tree_bytes = size_t(N) * 8 + size_t(L) * 4;
  int c = (int)(CHUNK_BYTES / tree_bytes);
  c = c < 1 ? 1 : (c > bt ? bt : c);
  if (c > TREE_ILP) c -= c % TREE_ILP;
  *rows = r;
  *ct = c;
  *smem = heap::align16(size_t(r) * d_pad * 2) + heap::align16(size_t(c) * N * 8) +
          heap::align16(size_t(c) * L * 4);
  return *smem <= MAX_SMEM ? cudaSuccess : cudaErrorInvalidValue;
}

// Column of row r in a sub-tile of `rows` rows (64, 128 or 256): 4-byte word
// j of a feature holds rows j (low half) and j + rows / 2 (high half), so the
// 32 rows of a warp sit in 32 consecutive words, one a bank.
__device__ __forceinline__ int row_col(int r, int rows) {
  const int half = rows >> 1;
  return 2 * (r & (half - 1)) + (r >= half);
}

// Rows [base, base + rows) of feature-major xT into the sub-tile xs in
// row_col's layout; rows from `limit` on (past the tile's end) are zero. A
// thread moves 8 words at a time: rows j .. j + 7 and j + rows / 2 .. j +
// rows / 2 + 7 of a feature in two 16-byte loads, their halves paired into
// two 16-byte stores (bn, and so base, limit and n_pad, are multiples of 8).
__device__ __forceinline__ void stage_rows(const Tiles& P, long long base, int limit,
                                           uint16_t* xs) {
  const int half = P.rows >> 1;
  const int per_f = half >> 3;
  uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
  for (int q = threadIdx.x; q < P.d_pad * per_f; q += blockDim.x) {
    const int f = q / per_f;
    const int j = (q - f * per_f) * 8;
    const uint16_t* src = P.xT + (size_t)f * P.n_pad + base;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 a = j < limit ? __ldg(reinterpret_cast<const uint4*>(src + j)) : zero;
    const uint4 b =
        j + half < limit ? __ldg(reinterpret_cast<const uint4*>(src + j + half)) : zero;
    uint4* dst = reinterpret_cast<uint4*>(xw + f * half + j);
    dst[0] = make_uint4(__byte_perm(a.x, b.x, 0x5410), __byte_perm(a.x, b.x, 0x7632),
                        __byte_perm(a.y, b.y, 0x5410), __byte_perm(a.y, b.y, 0x7632));
    dst[1] = make_uint4(__byte_perm(a.z, b.z, 0x5410), __byte_perm(a.z, b.z, 0x7632),
                        __byte_perm(a.w, b.w, 0x5410), __byte_perm(a.w, b.w, 0x7632));
  }
}

// A leaf's payload word: the f32 bits (leaf_f32), else the bf16 planes hi
// (low half) and lo (high half), added in f32.
__device__ __forceinline__ float payload(uint32_t w, int leaf_f32) {
  return leaf_f32 ? __uint_as_float(w)
                  : __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
}

// An ablation stage of tree `nd` for the row in column col: the root's
// bf16 feature (SEL) or its compare (CMP); the true compares on the left
// spine 0, 1, 3, 7, ..., which are leaf 0's ancestors, each going left
// (MAIN, leaf 0's ancestor-agreement count); whether all of them are true
// (EQ: the count equals leaf 0's target, the depth).
__device__ __forceinline__ float ablated(const int2* nd, const uint16_t* xs, int stride, int col,
                                         int depth, int ablate) {
  const float x0 = heap::bf16_bits_to_float(xs[nd[0].x * stride + col]);
  if (ablate == SEL) return x0;
  if (ablate == CMP) return x0 <= __int_as_float(nd[0].y) ? 1.0f : 0.0f;
  int count = 0;
  for (int k = 0, v = 0; k < depth; ++k, v = 2 * v + 1) {
    count += heap::bf16_bits_to_float(xs[nd[v].x * stride + col]) <= __int_as_float(nd[v].y);
  }
  if (ablate == MAIN) return (float)count;
  return count == depth ? 1.0f : 0.0f;
}

// The block's (row tile, tree tile). stage(c0, nt, nodes, pay) fills the
// node words [nt][N] and payload words [nt][L] of trees c0 .. c0 + nt - 1
// with the whole block.
template <class Stage>
__device__ __forceinline__ void walk_tiles(const Tiles& P, Stage stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  int2* nodes = reinterpret_cast<int2*>(smem + heap::align16(size_t(P.rows) * P.d_pad * 2));
  uint32_t* pay = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(nodes) +
                                              heap::align16(size_t(P.ct) * P.N * 8));
  const int row_tiles = P.n_pad / P.bn;
  const int tree_tiles = (P.T + P.bt - 1) / P.bt;
  const int b = blockIdx.x;
  const int ti = P.tree_outer ? b / row_tiles : b % tree_tiles;
  const int ri = P.tree_outer ? b % row_tiles : b / tree_tiles;
  const long long row0 = (long long)ri * P.bn;
  const int t_end = min(ti * P.bt + P.bt, P.T);
  const int groups = blockDim.x / P.rows;
  const int r = threadIdx.x % P.rows;
  const int g = threadIdx.x / P.rows;
  const int col = row_col(r, P.rows);

  for (int c0 = ti * P.bt; c0 < t_end; c0 += P.ct) {
    const int nt = min(P.ct, t_end - c0);
    __syncthreads();  // every walk of the previous chunk is done
    stage(c0, nt, nodes, pay);
    for (int s0 = 0; s0 < P.bn; s0 += P.rows) {
      __syncthreads();  // the chunk has landed; the previous sub-tile is walked
      stage_rows(P, row0 + s0, P.bn - s0, xs);
      __syncthreads();
      const long long row = row0 + s0 + r;
      const bool live = s0 + r < P.bn && row < P.n;
      for (int b0 = g * TREE_ILP; b0 < nt; b0 += groups * TREE_ILP) {
        if (P.ablate == FULL) {
          const int2* tree_nodes[TREE_ILP];
          int cols[TREE_ILP], leaf[TREE_ILP];
#pragma unroll
          for (int j = 0; j < TREE_ILP; ++j) {
            tree_nodes[j] = nodes + min(b0 + j, nt - 1) * P.N;
            cols[j] = col;
          }
          heap::walk<TREE_ILP>(tree_nodes, xs, P.rows, cols, P.depth, leaf);
          if (live) {
#pragma unroll
            for (int j = 0; j < TREE_ILP; ++j) {
              if (b0 + j < nt) {
                P.out[(size_t)(c0 + b0 + j) * P.n + row] =
                    payload(pay[(b0 + j) * P.L + leaf[j]], P.leaf_f32);
              }
            }
          }
        } else if (live) {
          for (int j = 0; j < TREE_ILP && b0 + j < nt; ++j) {
            P.out[(size_t)(c0 + b0 + j) * P.n + row] =
                ablated(nodes + (b0 + j) * P.N, xs, P.rows, col, P.depth, P.ablate);
          }
        }
      }
    }
  }
}

// The checks both entry points make, and the grid: one block a (row tile,
// tree tile) pair.
inline cudaError_t grid_of(const Tiles& P, unsigned* blocks) {
  if (P.n <= 0 || P.T <= 0 || P.bn <= 0 || P.bn % 8 != 0 || P.bt <= 0 || P.n_pad < P.n ||
      P.n_pad % P.bn != 0 || P.depth < 0 || P.depth > heap::MAX_DEPTH ||
      P.L != (1 << P.depth) || P.N < P.L || P.N < 2) {
    return cudaErrorInvalidValue;
  }
  const long long b = (long long)(P.n_pad / P.bn) * ((P.T + P.bt - 1) / P.bt);
  if (b > 2147483647LL) return cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

}  // namespace ht
