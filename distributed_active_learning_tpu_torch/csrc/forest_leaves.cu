// Per-tree leaf values of a complete heap forest: the Hopper port of the
// JAX package's ops/trees_pallas.py::_kernel (body _leaf_rows), launched by
// predict_leaves_pallas there and by ops/trees_pallas.py::_launch_leaves
// here.
//
// out[t, row] = value[t, leaf(row, t)], where leaf(row, t) is the leaf the
// row reaches in tree t when each node compares the row's feature, rounded
// to bf16, against its f32 threshold (heap_walk.cuh). On a complete heap
// tree that is the TPU kernel's function exactly; forests of another shape
// are refused by the wrapper. The leaf values are read in their storage
// type, f32, bf16 or int8 (a quantized forest), and widened to f32 in
// registers before the store (leaf_payload.cuh): the kernel is one
// instantiation a payload type, and the f32 one is the kernel as it was.
//
// What bounds it on an H100. The function needs one compare per level of a
// row's root-to-leaf path: n * T * depth = 2.3e8 compares at the benchmark
// width (284,807 rows x 30 features, 100 trees, depth 8), ~3.4 us at the
// f32 rate of the CUDA cores, while the bytes it must move take ~0.044 ms
// at 3.35 TB/s: x once (34.2 MB), the forest once in its heap form (100
// trees x 3 KB), the [T, n] f32 output once (113.9 MB), ~148 MB in all. So
// it is bound by bytes, and most of them are the output.
//
// The design.
// - The walk. A root-to-leaf walk does depth compares per (row, tree). The
//   TPU needed a one-hot selection product and a path matrix because its
//   matrix unit cannot gather; an H100 thread gathers from shared memory in
//   one instruction, so the one-hot, the path matrix and the per-leaf
//   ancestor counts have no use here. Tensor cores are not used either: a
//   wgmma (int8) formulation would still compute all 2^depth leaf counts per
//   (row, tree), far more work than depth compares.
// - Rows. A block stages a tile of blockDim.x rows once, as bf16 transposed
//   [feature][row], so a warp's 32 rows gather from distinct banks (two rows
//   share a 4-byte word). Each thread owns one row of the tile and walks
//   four trees at a time, interleaved, to hide the walk's dependent shared
//   memory loads.
// - The forest in shared memory. A node is one 8-byte word (feature,
//   threshold), so one 64-bit load serves a level, and each tree's leaf
//   values sit beside its nodes (3 KB a tree at depth 8). The forest (300
//   KB at the bench width) does not fit, so chunks of trees stream through
//   a two-stage ring of cp.async copies (commit groups): chunk c + 1 arrives
//   while chunk c is walked. Node reads diverge at deep levels and cost a
//   few-way bank conflict. A quantized payload shrinks only the leaf half
//   of a tree's bytes (1 KB of f32 values at depth 8 becomes 512 or 256
//   bytes), so more trees fit a chunk; the walk itself is unchanged.
// - Persistent blocks. The work is (row tile, tree chunk) units in
//   tile-major order; the grid is the multiprocessors times the resident
//   blocks (occupancy API), and each block takes one contiguous range of
//   units. Every block gets the same number of units, give or take one, so
//   no launch ends on a half-empty wave, and consecutive units share a row
//   tile, so a block restages rows only when its tile changes and reads the
//   forest from L2 a handful of times.
// - Stores. out is tree-major: a warp's store for one tree is 128
//   contiguous bytes.

#include "heap_walk.cuh"
#include "leaf_payload.cuh"

namespace {

constexpr int MAX_THREADS = 256;             // rows of a tile, one thread each
constexpr int TREE_ILP = 4;                  // trees walked at once by a thread
constexpr int X_TILE_BYTES = 64 * 1024;      // bf16 row tile budget
constexpr int STAGE_BYTES = 24 * 1024;       // one tree chunk (8 trees at depth 8)

struct Config {
  int rows, ct, smem, grid;
};

template <class P>
__global__ void __launch_bounds__(MAX_THREADS, 2) forest_leaves_kernel(
    const float* __restrict__ x, int n, int d, const int2* __restrict__ nodes,
    const P* __restrict__ val, int T, int depth, int N, int Lp, int ct,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* stages = smem + heap::align16(size_t(rows) * d * sizeof(uint16_t));
  const int node_bytes = ct * N * 8;
  const int stage_bytes = node_bytes + ct * Lp * (int)sizeof(P);
  const int n_chunks = (T + ct - 1) / ct;
  const long long n_tiles = (n + rows - 1) / rows;
  const long long units = n_tiles * n_chunks;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;

  // Chunk of unit u into stage buffer buf: its trees' nodes, then their
  // leaf values.
  auto issue = [&](long long u, int buf) {
    const int t0 = (int)(u % n_chunks) * ct;
    const int nt = min(ct, T - t0);
    unsigned char* s = stages + buf * stage_bytes;
    heap::copy_async_16(s, nodes + (size_t)t0 * N, nt * N * 8);
    heap::copy_async_16(s + node_bytes, val + (size_t)t0 * Lp, nt * Lp * (int)sizeof(P));
  };

  if (u0 < u1) issue(u0, 0);
  heap::commit_async();
  long long cur_tile = -1;
  for (long long u = u0; u < u1; ++u) {
    const int buf = (int)((u - u0) & 1);
    if (u + 1 < u1) issue(u + 1, buf ^ 1);
    heap::commit_async();
    const long long tile = u / n_chunks;
    if (tile != cur_tile) {  // the previous unit's closing barrier freed xs
      heap::stage_rows_t(x, n, d, tile * rows, rows, rows, xs);
      cur_tile = tile;
    }
    heap::wait_async<1>();  // this unit's chunk has landed (the next may not)
    __syncthreads();
    const unsigned char* s = stages + buf * stage_bytes;
    const int2* nodes_s = reinterpret_cast<const int2*>(s);
    const P* val_s = reinterpret_cast<const P*>(s + node_bytes);
    const int t0 = (int)(u % n_chunks) * ct;
    const int nt = min(ct, T - t0);
    const long long row = tile * rows + threadIdx.x;
    for (int tt = 0; tt < nt; tt += TREE_ILP) {
      const int2* tree_nodes[TREE_ILP];
      int col[TREE_ILP], leaf[TREE_ILP];
#pragma unroll
      for (int j = 0; j < TREE_ILP; ++j) {
        tree_nodes[j] = nodes_s + min(tt + j, nt - 1) * N;
        col[j] = threadIdx.x;
      }
      heap::walk<TREE_ILP>(tree_nodes, xs, rows, col, depth, leaf);
      if (row < n) {
#pragma unroll
        for (int j = 0; j < TREE_ILP; ++j) {
          if (tt + j < nt) {
            out[(size_t)(t0 + tt + j) * n + row] = payload::widen(val_s[(tt + j) * Lp + leaf[j]]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage and with xs
  }
}

// The launch configuration for n rows of d features and T trees of the
// given depth, leaf values of type P: tile rows, trees per chunk, shared
// memory, grid. A tree's leaf values must be whole 16-byte pieces.
template <class P>
cudaError_t configure(int n, int d, int T, int depth, int N, int Lp, Config* c) {
  if (n <= 0 || d <= 0 || d > 1024 || T <= 0 || depth < 0 || depth > heap::MAX_DEPTH ||
      N < (1 << depth) || N % 2 != 0 || Lp < (1 << depth) || (Lp * sizeof(P)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  int rows = (X_TILE_BYTES / (2 * d)) / 32 * 32;
  c->rows = rows < 32 ? 32 : (rows > MAX_THREADS ? MAX_THREADS : rows);
  const int tree_bytes = N * 8 + Lp * (int)sizeof(P);
  int ct = STAGE_BYTES / tree_bytes;
  ct = ct < 1 ? 1 : (ct > T ? T : ct);
  if (ct >= TREE_ILP) ct -= ct % TREE_ILP;
  c->ct = ct;
  c->smem = (int)(heap::align16(size_t(c->rows) * d * sizeof(uint16_t)) + 2 * size_t(ct) * tree_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      forest_leaves_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, c->smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(forest_leaves_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, forest_leaves_kernel<P>, c->rows,
                                                       c->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = ((long long)(n + c->rows - 1) / c->rows) * ((T + ct - 1) / ct);
  const long long cap = (long long)sms * per_sm;
  c->grid = (int)(units < cap ? units : cap);
  return cudaSuccess;
}

}  // namespace

// The configuration forest_leaves would launch with: rows per tile (=
// threads per block), trees per chunk, dynamic shared memory bytes, grid.
// `payload` is the leaf type's code (leaf_payload.cuh).
extern "C" int forest_leaves_config(int n, int d, int payload, int T, int depth, int N, int Lp,
                                    int* out4) {
  return payload::dispatch(payload, [&](auto tag) {
    Config c;
    const cudaError_t err = configure<decltype(tag)>(n, d, T, depth, N, Lp, &c);
    if (err != cudaSuccess) return (int)err;
    out4[0] = c.rows;
    out4[1] = c.ct;
    out4[2] = c.smem;
    out4[3] = c.grid;
    return 0;
  });
}

extern "C" int forest_leaves(const float* x, int n, int d, const int2* nodes, const void* val,
                             int payload, int T, int depth, int N, int Lp, float* out,
                             void* stream) {
  return payload::dispatch(payload, [&](auto tag) {
    using P = decltype(tag);
    Config c;
    const cudaError_t err = configure<P>(n, d, T, depth, N, Lp, &c);
    if (err != cudaSuccess) return (int)err;
    forest_leaves_kernel<P><<<c.grid, c.rows, c.smem, (cudaStream_t)stream>>>(
        x, n, d, nodes, static_cast<const P*>(val), T, depth, N, Lp, c.ct, out);
    return (int)cudaGetLastError();
  });
}
