// Hard vote counts of a forest shard: the Hopper port of the JAX package's
// ops/round_fused.py::_votes_kernel (launched by fused_votes_pallas there, by
// ops/round_fused.py::_launch_votes here). It is the per-shard body of the
// mesh's fused round: each (data, model) shard counts the votes of its tree
// shard over its row block, and a sum over the model axis completes them.
//
//   votes[row] = sum_t [leaf_t(row) > 0.5]
//
// Each 128-row tile's votes are counted by a heap walk over the forest held
// in shared memory (heap_votes.cuh) and stored as [n] int32, coalesced, so
// the [n, T] leaf matrix never reaches device memory: that is the point of
// the TPU kernel, which accumulated tree tile by tree tile into a revisited
// VMEM output. Votes are integers, so every route (this kernel, its plain
// versions, the gemm branch past the tile limits) agrees bit for bit.
//
// What bounds it on an H100: the function needs depth + 1 compares per
// (row, tree) (the walk and the vote: 3.2e7 for one 71,202-row x 50-tree
// shard of the benchmark pool, under a microsecond at the data sheet's f32
// rate) against the bytes it must move (the row block once, the shard's
// heap form, the [n] int32 output: ~8.9 MB, ~2.7 us at 3.35 TB/s), so it is
// bound by bytes (chip_smoke.py phase 5 computes the bound). A 50-tree
// shard's packed heap form takes 52,800 bytes of shared memory, so it stays
// resident, and the walk reads device memory only for the rows; what holds
// it above the byte bound is the walk's shared-memory loads.

#include "heap_votes.cuh"

namespace {

struct Store {
  int* out;
  long long n;

  static constexpr int SCRATCH_BYTES = 0;

  __device__ void operator()(long long tile, const int* votes, unsigned char*) const {
    const long long row = tile * hv::TILE + threadIdx.x;
    if (threadIdx.x < hv::TILE && row < n) out[row] = votes[threadIdx.x];
  }
};

}  // namespace

// The configuration fused_votes would launch with (as
// round_megakernel_config).
extern "C" int fused_votes_config(int n, int d, int payload, int T, int depth, int N, int Lp,
                                  int* out6) {
  return payload::dispatch(payload, [&](auto tag) {
    using P = decltype(tag);
    const hv::Forest<P> F{nullptr, nullptr, T, depth, N, Lp};
    return hv::config_out<P, Store>(n, d, F, out6);
  });
}

extern "C" int fused_votes(const float* x, int n, int d, const int2* nodes, const void* val,
                           int payload, int T, int depth, int N, int Lp, int* votes,
                           void* stream) {
  return payload::dispatch(payload, [&](auto tag) {
    using P = decltype(tag);
    const hv::Forest<P> F{nodes, static_cast<const P*>(val), T, depth, N, Lp};
    return (int)hv::launch(x, n, d, F, Store{votes, n}, (cudaStream_t)stream);
  });
}
