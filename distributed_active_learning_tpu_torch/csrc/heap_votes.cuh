// Hard votes of a complete heap forest over persistent row tiles: the shared
// body of the round megakernel (round_megakernel.cu, K2) and the per-shard
// vote kernel (fused_votes.cu, K3).
//
//   votes[row] = sum_t [value_t(leaf_t(row)) > 0.5]
//
// where leaf_t(row) is the leaf the row reaches in tree t by the walk of
// heap_walk.cuh (bf16(x) <= the f32 threshold goes left, a NaN goes right).
// Each kernel hands the block's finished votes of a 128-row tile to its
// epilogue: K2 scores and ranks them, K3 stores them.
//
// The design.
// - A vote needs one bit a leaf, not the leaf's f32 value, and a resident
//   node needs 4 bytes: the feature id in the low half and, in the high
//   half, the largest bf16 value not above the f32 threshold (a NaN
//   threshold stays a NaN). The row's feature is a bf16 value, so bf16(x)
//   <= that bound exactly when bf16(x) <= the threshold. A depth-8 tree is
//   then 1,024 bytes of nodes and 32 of vote bits, and the 100-tree forest
//   of the benchmark (105,600 bytes) fits beside a 128-row bf16 tile of 30
//   features (7,680 bytes) in the 232,448 bytes of shared memory one block
//   may use.
// - Forest-resident mode (the forest fits): each block packs every tree's
//   nodes once, and derives the vote bits with one __ballot_sync(value >
//   0.5) per 32 leaves, so neither is an operand or costs a launch. The
//   block then walks its contiguous range of row tiles without restaging
//   the forest.
// - Streamed mode (wide rows or many trees): chunks of trees, nodes and
//   leaf values (the vote is the same value > 0.5 compare), stream through a
//   two-stage ring of cp.async copies over (row tile, tree chunk) units, as
//   in forest_leaves.cu, and heap_walk.cuh's walk reads them as they are; a
//   thread's votes stay in a register across the chunks of its tile.
// - Leaf payloads. The leaf values are f32, or a quantized forest's bf16 or
//   int8 (leaf_payload.cuh), a template parameter of the body: the ballot
//   and the streamed compare read the stored type and widen it in registers,
//   so a leaf's vote bit is widen(value) > 0.5. The resident forest holds
//   vote bits either way, so the payload changes only the bytes the ballot
//   reads once a block and the streamed stage's leaf half.
// - The walk. A tile holds 128 rows, one a thread of a group of 128
//   threads; the trees are split over the block's groups (eight at the
//   benchmark width, 1,024 threads), each thread walking four trees at once,
//   so the dependent shared-memory loads of a walk hide behind the other
//   walks. The groups' counts meet in shared memory (atomicAdd). All lanes
//   of a warp walk the same tree, so the top levels are broadcasts; below
//   them the lanes' nodes scatter, and the 4-byte node halves the bytes a
//   level loads. The rows' columns in the tile interleave so that a warp's
//   feature loads hit 32 distinct banks (row_col). What bounds the walk is
//   the shared-memory pipe: two dependent loads a level, 17 a walk. Loading
//   the next tile's rows and the epilogue's inputs into registers while a
//   tile is walked was measured and gained nothing, so a block stages them
//   when it needs them.
// - Persistent blocks: the grid is the multiprocessors times the resident
//   blocks (occupancy API), and each block takes one contiguous range of
//   row tiles, which every block gets in equal shares give or take one.

#pragma once

#include <algorithm>
#include <mutex>

#include "heap_walk.cuh"
#include "leaf_payload.cuh"

namespace hv {

constexpr int TILE = 128;                      // rows of a tile, one a thread of a group
constexpr int TREE_ILP = 4;                    // trees walked at once by a thread
constexpr int MAX_GROUPS = 8;                  // groups of TILE threads a block
constexpr int MAX_THREADS = TILE * MAX_GROUPS;
constexpr int ROW_BATCH = 8;                   // x values a thread loads at once

enum Mode { RESIDENT = 0, STREAMED = 1 };

template <class P>
struct Forest {
  const int2* nodes;  // [T, N] node words (feature id, threshold bits), heap order
  const P* val;       // [T, Lp] leaf values (f32, bf16 or int8)
  int T, depth, N, Lp;
};

// 32-bit words of vote bits a tree (bit l % 32 of word l / 32 is leaf l's).
__host__ __device__ inline int vote_words(int depth) { return ((1 << depth) + 31) / 32; }

// Column of row r in the tile xs[feature][column]: the four warps' rows
// interleave so that the 32 lanes of a warp read 32 distinct 4-byte words,
// whatever feature each lane's walk asks for (row i of warps 0 and 2 share
// word i, of warps 1 and 3 word 32 + i).
__device__ __forceinline__ int row_col(int r) {
  return 2 * ((r & 31) + 32 * ((r >> 5) & 1)) + (r >> 6);
}

// Shared-memory layout (byte offsets): the bf16 row tile, the tile's vote
// counts, the epilogue's scratch, then the forest (resident: every tree's
// packed nodes, then every tree's vote bits) or two stages of `ct` trees
// each (nodes, then leaf values).
struct Layout {
  size_t votes, scratch, forest, stage, bytes;
};

template <class P>
__host__ __device__ inline Layout layout(int d, const Forest<P>& F, bool resident, int ct,
                                         int scratch_bytes) {
  Layout lo;
  lo.votes = heap::align16(size_t(d) * TILE * sizeof(uint16_t));
  lo.scratch = lo.votes + heap::align16(TILE * sizeof(int));
  lo.forest = lo.scratch + heap::align16(size_t(scratch_bytes));
  if (resident) {
    lo.stage = 0;
    lo.bytes = lo.forest + heap::align16(size_t(F.T) * F.N * 4) +
               heap::align16(size_t(F.T) * vote_words(F.depth) * 4);
  } else {
    lo.stage = size_t(ct) * (size_t(F.N) * 8 + size_t(F.Lp) * sizeof(P));
    lo.bytes = lo.forest + 2 * lo.stage;
  }
  return lo;
}

// (feature id, f32 threshold bits) -> (bf16 bound << 16) | feature id, the
// bound being the largest bf16 value <= the threshold. Dropping the low 16
// bits rounds toward zero, which is down for a positive threshold and up for
// a negative one, so a negative threshold with dropped bits steps one bf16
// further from zero (-max f32 rounds to -inf, as it should).
__device__ __forceinline__ uint32_t pack_node(int2 nd) {
  const uint32_t t = (uint32_t)nd.y;
  uint32_t hi = t & 0xffff0000u;
  if ((t & 0x7fffffffu) > 0x7f800000u) {
    hi = 0x7fc00000u;  // NaN: every compare is false
  } else if ((t & 0x80000000u) && (t & 0xffffu)) {
    hi += 0x10000u;
  }
  return hi | ((uint32_t)nd.x & 0xffffu);
}

// heap::walk over packed nodes: R walks interleaved, walk j down tree
// nodes[j] for the row in column col of xs.
template <int R>
__device__ __forceinline__ void walk_packed(const uint32_t* const (&nodes)[R],
                                            const uint16_t* __restrict__ xs, int col, int depth,
                                            int (&leaf)[R]) {
  int v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = 0;
#pragma unroll
  for (int lvl = 0; lvl < heap::MAX_DEPTH; ++lvl) {
    if (lvl < depth) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint32_t nd = nodes[j][v[j]];
        const float xv = heap::bf16_bits_to_float(xs[(nd & 0xffffu) * TILE + col]);
        v[j] = 2 * v[j] + 1 + (int)!(xv <= __uint_as_float(nd & 0xffff0000u));
      }
    }
  }
  const int internal = (1 << depth) - 1;
#pragma unroll
  for (int j = 0; j < R; ++j) leaf[j] = v[j] - internal;
}

// Votes of row r over the trees [0, nt) of a staged chunk that fall to
// group g: trees g * 4 .. g * 4 + 3, then those G * 4 further on, and so
// on. Resident chunks read packed nodes and the vote bits (`bits`,
// vote_words a tree), streamed ones node words and the leaf values (`val`,
// Lp a tree).
template <bool RESIDENT, class P>
__device__ __forceinline__ int count_votes(const void* nodes_v, const uint32_t* __restrict__ bits,
                                           const P* __restrict__ val, int nt,
                                           const Forest<P>& F, const uint16_t* __restrict__ xs,
                                           int g, int G, int r) {
  const int W = vote_words(F.depth);
  const int col = row_col(r);
  int cnt = 0;
  for (int tt = g * TREE_ILP; tt < nt; tt += G * TREE_ILP) {
    int leaf[TREE_ILP];
    if (RESIDENT) {
      const uint32_t* nodes = static_cast<const uint32_t*>(nodes_v);
      const uint32_t* tree_nodes[TREE_ILP];
#pragma unroll
      for (int j = 0; j < TREE_ILP; ++j) tree_nodes[j] = nodes + min(tt + j, nt - 1) * F.N;
      walk_packed<TREE_ILP>(tree_nodes, xs, col, F.depth, leaf);
    } else {
      const int2* nodes = static_cast<const int2*>(nodes_v);
      const int2* tree_nodes[TREE_ILP];
      int cols[TREE_ILP];
#pragma unroll
      for (int j = 0; j < TREE_ILP; ++j) {
        tree_nodes[j] = nodes + min(tt + j, nt - 1) * F.N;
        cols[j] = col;
      }
      heap::walk<TREE_ILP>(tree_nodes, xs, TILE, cols, F.depth, leaf);
    }
#pragma unroll
    for (int j = 0; j < TREE_ILP; ++j) {
      if (tt + j < nt) {
        if (RESIDENT) {
          cnt += (int)((bits[(tt + j) * W + (leaf[j] >> 5)] >> (leaf[j] & 31)) & 1u);
        } else {
          cnt += payload::widen(val[(tt + j) * F.Lp + leaf[j]]) > 0.5f ? 1 : 0;
        }
      }
    }
  }
  return cnt;
}

// Rows [base, base + TILE) of the row-major [n, d] matrix x into the tile
// as bf16 (round to nearest even); rows past n are zero. Element j is
// feature j / TILE of row j % TILE, so a warp's stores fill 32 distinct
// banks (its loads read 32 rows of one feature from the L1). Each thread
// starts ROW_BATCH loads before it stores any.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, long long n, int d,
                                           long long base, uint16_t* __restrict__ xs) {
  for (int j0 = threadIdx.x; j0 < TILE * d; j0 += ROW_BATCH * blockDim.x) {
    float v[ROW_BATCH];
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k) {
      const int j = j0 + k * blockDim.x;
      const long long row = base + j % TILE;
      v[k] = j < TILE * d && row < n ? x[row * d + j / TILE] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < TILE * d) xs[j - j % TILE + row_col(j % TILE)] = heap::to_bf16_bits(v[k]);
    }
  }
}

// The kernel body. Epi is the kernel's epilogue, with Epi::SCRATCH_BYTES of
// shared memory: epi(tile, votes, scratch) runs on every thread of the block
// once a tile's votes are complete (votes[r] for row tile * TILE + r); the
// call may hold block barriers.
template <bool RESIDENT, class P, class Epi>
__global__ void __launch_bounds__(MAX_THREADS) vote_tiles(
    const float* __restrict__ x, int n, int d, Forest<P> F, int ct, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lo = layout(d, F, RESIDENT, ct, Epi::SCRATCH_BYTES);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  int* votes = reinterpret_cast<int*>(smem + lo.votes);
  unsigned char* scratch = smem + lo.scratch;
  unsigned char* forest = smem + lo.forest;
  const int G = blockDim.x / TILE;
  const int g = threadIdx.x / TILE;
  const int r = threadIdx.x - g * TILE;
  const int nc = RESIDENT ? 1 : (F.T + ct - 1) / ct;
  const long long tiles = ((long long)n + TILE - 1) / TILE;
  const long long u0 = tiles * blockIdx.x / gridDim.x * nc;
  const long long u1 = tiles * (blockIdx.x + 1) / gridDim.x * nc;
  if (u0 >= u1) return;

  const int W = vote_words(F.depth);
  uint32_t* res_bits = reinterpret_cast<uint32_t*>(forest + heap::align16(size_t(F.T) * F.N * 4));
  // Chunk of unit u into stage buffer buf: its trees' nodes, then their leaf
  // values (streamed mode).
  auto fetch_chunk = [&](long long u, int buf) {
    const int t0 = (int)(u % nc) * ct;
    const int nt = min(ct, F.T - t0);
    unsigned char* s = forest + buf * lo.stage;
    heap::copy_async_16(s, F.nodes + (size_t)t0 * F.N, nt * F.N * 8);
    heap::copy_async_16(s + size_t(ct) * F.N * 8, F.val + (size_t)t0 * F.Lp,
                        nt * F.Lp * (int)sizeof(P));
  };

  if (RESIDENT) {
    uint32_t* packed = reinterpret_cast<uint32_t*>(forest);
#pragma unroll 4
    for (int i = threadIdx.x; i < F.T * F.N; i += blockDim.x) packed[i] = pack_node(F.nodes[i]);
    // The vote bits: warp w packs words w, w + warps, ... (tree p / W,
    // leaves 32 (p % W) ..).
    const int lane = threadIdx.x & 31;
    const int L = 1 << F.depth;
    for (int p = threadIdx.x >> 5; p < F.T * W; p += blockDim.x >> 5) {
      const int t = p / W;
      const int leaf = (p - t * W) * 32 + lane;
      const bool v = leaf < L && payload::widen(F.val[(size_t)t * F.Lp + leaf]) > 0.5f;
      const uint32_t word = __ballot_sync(0xffffffffu, v);
      if (lane == 0) res_bits[p] = word;
    }
  } else {
    fetch_chunk(u0, 0);
    heap::commit_async();
  }

  int cnt = 0;
  for (long long u = u0; u < u1; ++u) {
    const int buf = (int)((u - u0) & 1);
    const int c = (int)(u % nc);
    const long long tile = u / nc;
    if (!RESIDENT) {
      if (u + 1 < u1) fetch_chunk(u + 1, buf ^ 1);
      heap::commit_async();
    }
    if (c == 0) {  // the previous unit's closing barrier freed xs and votes
      stage_rows(x, n, d, tile * TILE, xs);
      if (threadIdx.x < TILE) votes[threadIdx.x] = 0;
      cnt = 0;
    }
    if (!RESIDENT) heap::wait_async<1>();  // this unit's chunk has landed (the next may not)
    __syncthreads();
    if (RESIDENT) {
      cnt = count_votes<true, P>(forest, res_bits, nullptr, F.T, F, xs, g, G, r);
    } else {
      const unsigned char* s = forest + buf * lo.stage;
      cnt += count_votes<false, P>(s, nullptr,
                                   reinterpret_cast<const P*>(s + size_t(ct) * F.N * 8),
                                   min(ct, F.T - c * ct), F, xs, g, G, r);
    }
    if (c == nc - 1) {
      atomicAdd(&votes[r], cnt);
      __syncthreads();
      epi(tile, votes, scratch);
    }
    __syncthreads();  // every thread is done with this stage, xs and votes
  }
}

struct Config {
  int mode, groups, ct, smem, grid, per_sm;
};

// The configuration for n rows of d features: the mode (resident when the
// whole forest fits beside the tile), the groups of TILE threads a block
// (one group per four trees of a chunk, up to MAX_GROUPS: eight groups took
// the least time at the benchmark width, see PERF.md), trees a chunk, shared
// memory, the persistent grid and the blocks a multiprocessor holds, for the
// kernel of epilogue Epi. All but the grid depend on the device and the
// forest's shape only and are cached per (device, d, T, depth, N, Lp) of
// each payload type P, so a launch of a shape seen before makes no CUDA call
// but cudaGetDevice; the kernels' shared-memory limit is raised to the
// device's opt-in maximum once, so every cached configuration stays
// launchable. A tree's leaf values must be whole 16-byte pieces.
template <class P, class Epi>
cudaError_t configure(int n, int d, const Forest<P>& F, Config* c) {
  if (n <= 0 || d <= 0 || d > 1024 || F.T <= 0 || F.depth < 0 || F.depth > heap::MAX_DEPTH ||
      F.N < (1 << F.depth) || F.N < 2 || F.N % 2 != 0 || F.Lp < (1 << F.depth) ||
      (F.Lp * sizeof(P)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  struct Entry {
    int key[6];
    Config c;
    int sms;
  };
  constexpr int SLOTS = 32;
  static std::mutex mu;
  static Entry cache[SLOTS];
  static int filled = 0;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  const int key[6] = {dev, d, F.T, F.depth, F.N, F.Lp};
  const long long tiles = ((long long)n + TILE - 1) / TILE;
  auto finish = [&](const Entry& e) {
    *c = e.c;
    const long long cap = (long long)e.sms * c->per_sm;
    c->grid = (int)(tiles < cap ? tiles : cap);
    return cudaSuccess;
  };
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled && i < SLOTS; ++i) {
    if (std::equal(key, key + 6, cache[i].key)) return finish(cache[i]);
  }

  Entry e;
  std::copy(key, key + 6, e.key);
  int optin = 0;
  if ((err = cudaDeviceGetAttribute(&e.sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess) {
    return err;
  }
  const int scratch = Epi::SCRATCH_BYTES;
  Layout lo = layout(d, F, true, F.T, scratch);
  const bool resident = lo.bytes <= (size_t)optin;
  e.c.mode = resident ? RESIDENT : STREAMED;
  if (resident) {
    e.c.ct = F.T;
  } else {
    lo = layout(d, F, false, 0, scratch);
    if (lo.forest >= (size_t)optin) return cudaErrorInvalidValue;
    const size_t tree_bytes = size_t(F.N) * 8 + size_t(F.Lp) * sizeof(P);
    int ct = (int)(((size_t)optin - lo.forest) / (2 * tree_bytes));
    if (ct < 1) return cudaErrorInvalidValue;
    ct = ct > F.T ? F.T : ct;
    if (ct >= TREE_ILP * MAX_GROUPS) ct -= ct % (TREE_ILP * MAX_GROUPS);
    e.c.ct = ct;
    lo = layout(d, F, false, ct, scratch);
  }
  e.c.smem = (int)lo.bytes;
  const int batches = (e.c.ct + TREE_ILP - 1) / TREE_ILP;
  e.c.groups = batches < MAX_GROUPS ? batches : MAX_GROUPS;
  auto kernel = resident ? vote_tiles<true, P, Epi> : vote_tiles<false, P, Epi>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&e.c.per_sm, kernel, e.c.groups * TILE,
                                                      e.c.smem);
  if (err != cudaSuccess) return err;
  if (e.c.per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[filled++ % SLOTS] = e;
  return finish(e);
}

template <class P, class Epi>
cudaError_t launch(const float* x, int n, int d, const Forest<P>& F, const Epi& epi,
                   cudaStream_t stream) {
  Config c;
  const cudaError_t err = configure<P, Epi>(n, d, F, &c);
  if (err != cudaSuccess) return err;
  auto kernel = c.mode == RESIDENT ? vote_tiles<true, P, Epi> : vote_tiles<false, P, Epi>;
  kernel<<<c.grid, c.groups * TILE, c.smem, stream>>>(x, n, d, F, c.ct, epi);
  return cudaGetLastError();
}

template <class P, class Epi>
int config_out(int n, int d, const Forest<P>& F, int* out6) {
  Config c;
  const cudaError_t err = configure<P, Epi>(n, d, F, &c);
  if (err != cudaSuccess) return (int)err;
  out6[0] = c.mode;
  out6[1] = c.groups;
  out6[2] = c.ct;
  out6[3] = c.smem;
  out6[4] = c.grid;
  out6[5] = c.per_sm;
  return 0;
}

}  // namespace hv
