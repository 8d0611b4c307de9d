// Root-to-leaf walk of complete heap trees, and the staging it reads from:
// the shared body of the heap-walk forest kernels (forest_leaves.cu).
//
// A complete depth-D tree in heap layout has I = 2^D - 1 internal nodes
// (node v's children at 2v + 1 and 2v + 2) and L = 2^D leaves. Each node is
// one 8-byte word, (feature id, f32 threshold bits), so one 64-bit shared
// memory load serves a level. A row goes left where its feature, rounded to
// bf16 with round-to-nearest-even, compares <= the node's f32 threshold, and
// right otherwise (a NaN feature compares false, so it goes right):
//
//   v = 0; repeat D times: v = 2v + 1 + !(bf16(x[feat[v]]) <= thr[v]);
//   leaf = v - I.
//
// On such a tree this is the path-matrix function of the TPU kernels
// exactly: the leaf whose ancestor-agreement count equals its target is the
// unique leaf whose left ancestors all compare true and whose right
// ancestors all compare false, which is the leaf the walk reaches.
//
// Rows sit in shared memory transposed, xs[feature * stride + row], as bf16
// bits: the 32 lanes of a warp hold 32 consecutive rows, so a gather at one
// feature reads 64 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace heap {

constexpr int MAX_DEPTH = 8;

__device__ __forceinline__ uint16_t to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Rows [base, base + rows) of the row-major [n, d] matrix x, as bf16, into
// xs[f * stride + r]; rows past n are zero. The rows are contiguous in x, so
// the load is one coalesced sweep.
__device__ inline void stage_rows_t(const float* __restrict__ x, long long n, int d,
                                    long long base, int rows, int stride,
                                    uint16_t* __restrict__ xs) {
  const int total = rows * d;
  const long long start = base * d;
  const long long limit = n * d;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const long long g = start + j;
    const float v = g < limit ? x[g] : 0.0f;
    const int r = j / d;
    const int f = j - r * d;
    xs[f * stride + r] = to_bf16_bits(v);
  }
}

// Asynchronous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory by the whole block, in one
// cp.async commit group per call site's commit.
__device__ inline void copy_async_16(void* smem_dst, const void* gmem_src, int bytes) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  const char* src = static_cast<const char*>(gmem_src);
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + o), "l"(src + o)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `N` of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R independent walks interleaved, to hide the dependent shared-memory loads
// of each: walk j follows tree nodes[j] (its nodes, heap order) for the row
// in column col[j] of xs. Returns each walk's leaf index in [0, 2^depth).
template <int R>
__device__ __forceinline__ void walk(const int2* const (&nodes)[R], const uint16_t* __restrict__ xs,
                                     int stride, const int (&col)[R], int depth, int (&leaf)[R]) {
  int v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = 0;
#pragma unroll
  for (int lvl = 0; lvl < MAX_DEPTH; ++lvl) {
    if (lvl < depth) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int2 nd = nodes[j][v[j]];
        const float xv = bf16_bits_to_float(xs[nd.x * stride + col[j]]);
        v[j] = 2 * v[j] + 1 + (int)!(xv <= __int_as_float(nd.y));
      }
    }
  }
  const int internal = (1 << depth) - 1;
#pragma unroll
  for (int j = 0; j < R; ++j) leaf[j] = v[j] - internal;
}

}  // namespace heap
