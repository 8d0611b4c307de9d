// The round megakernel: forest eval -> hard votes -> acquisition score ->
// per-tile top-k in one pass over the pool. The Hopper port of the JAX
// package's ops/round_fused.py::_mega_kernel (launched by _megakernel there
// and by ops/round_fused.py::_launch_megakernel here).
//
// Each 128-row tile's votes are counted by a heap walk over the forest held
// in shared memory (heap_votes.cuh), so neither the [n, T] leaf matrix nor
// the score vector ever reaches device memory: that is the point of the
// kernel. With the tile's votes complete, each row's directed score is
//   work = table[votes] + (selectable ? 0 : -inf),
// where table[v] is the strategy's score of p = v / T computed by the
// wrapper with the port's own scoring functions (votes are integers in
// [0, T], so the score takes only T + 1 values and no transcendental runs
// here); rows past n are never selectable. The tile's candidates are ranked
// exactly: a row's rank is the number of rows with a larger score, or an
// equal score and a lower index, so the first kk ranks are the tile's
// top-kk in lax.top_k's order (value descending, index ascending). The
// block's groups split the 128 x 128 compares of the rank between them.
// ops/topk.py::merge_tile_topk merges the tiles.
//
// What bounds it on an H100: the function needs depth + 1 compares per
// (row, tree) (the walk and the vote, ~2.6e8 at the benchmark width,
// 284,807 rows x 100 trees of depth 8, ~4 us at the f32 rate) against ~36
// MB of bytes (x once, the forest in its heap form, the mask, the table and
// the candidates written), ~0.011 ms at 3.35 TB/s: it is bound by bytes.
// The design (heap_votes.cuh) keeps the whole forest in shared memory at
// that width, so the walk reads device memory only for
// the rows; what holds it above the byte bound is the walk's shared-memory
// loads (PERF.md gives the measured share).

#include "heap_votes.cuh"

namespace {

struct Select {
  const unsigned char* selectable;
  const float* table;
  long long n;
  int kk;
  float* out_vals;
  int* out_idx;

  // Scratch: work [TILE] f32, rank [TILE] int. The [T + 1] score table is
  // read where it lies (one load a row), so T is not bounded by shared memory.
  static constexpr int SCRATCH_BYTES = 2 * hv::TILE * 4;

  __device__ void operator()(long long tile, const int* votes, unsigned char* scratch) const {
    float* work = reinterpret_cast<float*>(scratch);
    int* rank = reinterpret_cast<int*>(scratch + hv::TILE * 4);
    const int G = blockDim.x / hv::TILE;
    const int g = threadIdx.x / hv::TILE;
    const int r = threadIdx.x - g * hv::TILE;
    const long long row = tile * hv::TILE + r;
    const float neg_inf = __uint_as_float(0xff800000u);
    if (g == 0) {
      float w = neg_inf;  // padding rows past n are never selectable
      if (row < n) w = __ldg(table + votes[r]) + (selectable[row] ? 0.0f : neg_inf);
      work[r] = w;
      rank[r] = 0;
    }
    __syncthreads();
    const float w = work[r];
    int part = 0;
    for (int j = g * hv::TILE / G; j < (g + 1) * hv::TILE / G; ++j) {
      const float o = work[j];
      part += (o > w || (o == w && j < r)) ? 1 : 0;
    }
    atomicAdd(&rank[r], part);
    __syncthreads();
    if (g == 0 && rank[r] < kk) {
      out_vals[tile * kk + rank[r]] = w;
      out_idx[tile * kk + rank[r]] = (int)row;
    }
  }
};

}  // namespace

// The configuration round_megakernel would launch with: mode (0 resident,
// 1 streamed), groups of 128 threads a block, trees a chunk, dynamic
// shared memory bytes, grid, blocks a multiprocessor. `payload` is the leaf
// type's code (leaf_payload.cuh).
extern "C" int round_megakernel_config(int n, int d, int payload, int T, int depth, int N,
                                       int Lp, int* out6) {
  return payload::dispatch(payload, [&](auto tag) {
    using P = decltype(tag);
    const hv::Forest<P> F{nullptr, nullptr, T, depth, N, Lp};
    return hv::config_out<P, Select>(n, d, F, out6);
  });
}

extern "C" int round_megakernel(const float* x, int n, int d, const int2* nodes, const void* val,
                                int payload, int T, int depth, int N, int Lp,
                                const unsigned char* selectable, const float* table, int kk,
                                float* out_vals, int* out_idx, void* stream) {
  if (kk < 1 || kk > hv::TILE) return (int)cudaErrorInvalidValue;
  const Select epi{selectable, table, n, kk, out_vals, out_idx};
  return payload::dispatch(payload, [&](auto tag) {
    using P = decltype(tag);
    const hv::Forest<P> F{nodes, static_cast<const P*>(val), T, depth, N, Lp};
    return (int)hv::launch(x, n, d, F, epi, (cudaStream_t)stream);
  });
}
