// Leaf payloads of the forest kernels (forest_leaves.cu, K1, and the vote
// kernels on heap_votes.cuh, K2 and K3): a forest's leaf values are stored
// as f32, or quantized as bf16 or on a fixed int8 grid
// (ops/trees_train.py::quantize_forest), and each kernel reads the stored
// type and widens it in registers, as the TPU kernels' shared body
// (ops/trees_pallas.py::_leaf_rows) dequantizes right before its leaf
// product. No f32 copy of the forest is made for a kernel.
//
//   f32   as it is;
//   bf16  widened (exact);
//   int8  q * f32(1/127): a multiply by the f32 reciprocal, as the JAX
//         package spells it (models/forest.py::dequantize_leaf_values); a
//         division by 127 differs in the last bit.
//
// The entry points take the payload as a code (the wrapper's
// trees_pallas.PAYLOAD_CODES) and dispatch to one instantiation each; any
// other code is refused before a launch.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace payload {

enum Code { F32 = 0, BF16 = 1, INT8 = 2 };

// f32(1/127), bit pattern 0x3c010204.
constexpr float INT8_STEP = 0.007874015718698502f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return __fmul_rn((float)v, INT8_STEP); }

// Bytes of one stored leaf value.
inline int size_of(int code) { return code == F32 ? 4 : code == BF16 ? 2 : code == INT8 ? 1 : 0; }

// Calls f(P{}) with P the payload type of `code` (float, __nv_bfloat16,
// int8_t); an unknown code returns cudaErrorInvalidValue with no call.
template <class F>
int dispatch(int code, F&& f) {
  switch (code) {
    case F32: return f(float{});
    case BF16: return f(__nv_bfloat16{});
    case INT8: return f(int8_t{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace payload
