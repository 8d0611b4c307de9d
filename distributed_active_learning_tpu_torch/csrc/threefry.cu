// The neural path's random draws (K7): jax.random's partitionable threefry2x32
// bits, as uniform floats in [0, 1) (the dropout masks) and as the
// Gumbel-max categorical draw (the minibatch indices, BADGE's D^2 seeding and
// BatchBALD's configuration draws), launched by ops/threefry.py.
//
// No Pallas kernel stands behind these: the JAX package leaves jax.random to
// XLA (models/neural.py: flax's Dropout, jax.random.categorical at :144;
// strategies/deep.py), which fuses the hash into one pass. In eager PyTorch
// (prng.py, the plain version) each threefry round is its own pass over
// int64 tensors, about 120 passes of 24 bytes an element, and a round draws
// 6.4e8 Gumbels for the CIFAR-width minibatches alone (200 steps x 64 rows x
// 50,000 pool rows); PERF.md gives the measured cost of both forms a round.
// Here each thread hashes its own counters in registers and writes 4 bytes
// an element (uniform), or reduces its Gumbels to one (value, index) pair
// (categorical), so the work is integer ALU bound: about 100 32-bit
// operations a hash.
//
// Bits: element i of key (k1, k2) is threefry2x32((k1, k2), (i >> 32, i &
// 0xffffffff)), the two output words xor-ed (jax._src.prng
// _threefry_random_bits_partitionable); a uniform is the top 23 bits as the
// mantissa of a float in [1, 2), minus 1 (jax.random.uniform). The Gumbel is
// -log(-log(max(u + tiny, tiny))) with XLA CPU's float32 log (Cephes' logf
// with its fused multiply-adds, ops/xla_f32.py log_f32), every other
// operation rounded on its own (__f*_rn: nvcc must not contract them), so
// the card gives the plain version's bits. The categorical is the argmax of
// gumbel + logits over a row, the first index on a tie.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k1, uint32_t k2, uint64_t i) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = (uint32_t)(i >> 32) + ks[0];
  uint32_t b = (uint32_t)(i & 0xffffffffu) + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[g % 2][j]) ^ a;
    }
    a += ks[(g + 1) % 3];
    b += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  return a ^ b;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fsub_rn(__int_as_float((int)((bits >> 9) | 0x3F800000u)), 1.0f);
}

// XLA CPU's float32 log, operation for operation as ops/xla_f32.py log_f32.
__device__ float xla_log(float x) {
  const float min_normal = __int_as_float(0x00800000);
  const float xc = fmaxf(x, min_normal);
  const int bits = __float_as_int(xc);
  float e = __fadd_rn((float)((bits >> 23) - 0x7F), 1.0f);
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool low = m < __int_as_float(0x3f3504f3);  // f32(sqrt(1/2))
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  const float p0 = __int_as_float(0x3d9021bb), p1 = __int_as_float(0xbdebd1b8),
              p2 = __int_as_float(0x3def251a), p3 = __int_as_float(0xbdfe5d4f),
              p4 = __int_as_float(0x3e11e9bf), p5 = __int_as_float(0xbe2aae50),
              p6 = __int_as_float(0x3e4cceac), p7 = __int_as_float(0xbe7ffffc),
              p8 = __int_as_float(0x3eaaaaaa);
  const float q1 = __int_as_float(0xb95e8083), q2 = __int_as_float(0x3f318000);
  float y = fmaf(fmaf(t, p0, p1), t, p2);
  const float y1 = fmaf(fmaf(t, p3, p4), t, p5);
  const float y2 = fmaf(fmaf(t, p6, p7), t, p8);
  y = fmaf(fmaf(y, x3, y1), x3, y2);
  y = fmaf(y, x3, __fmul_rn(e, q1));
  float out = __fadd_rn(__fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, x2)), y), __fmul_rn(e, q2));
  if (x == 0.0f) out = -INFINITY;
  if (x == INFINITY) out = INFINITY;
  if (x < 0.0f || isnan(x)) out = NAN;
  return out;
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float tiny = __int_as_float(0x00800000);
  const float u = fmaxf(__fadd_rn(uniform01(bits), tiny), tiny);
  return -xla_log(-xla_log(u));
}

// out[i] = uniform01(bits(key, i)), grid-stride over n.
__global__ void __launch_bounds__(THREADS) uniform_kernel(const int64_t* __restrict__ key,
                                                         int64_t n, float* __restrict__ out) {
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    out[i] = uniform01(bits_at(k1, k2, (uint64_t)i));
  }
}

// One block a row: out[r] = argmax_j gumbel(bits(key, r * n + j)) +
// logits[r * stride + j], the first index on a tie.
__global__ void __launch_bounds__(THREADS) categorical_kernel(const int64_t* __restrict__ key,
                                                             int64_t n,
                                                             const float* __restrict__ logits,
                                                             int64_t stride,
                                                             int* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  const float* row = logits + r * stride;
  float best = -INFINITY;
  int64_t best_j = INT64_MAX;
  for (int64_t j = threadIdx.x; j < n; j += THREADS) {
    const float v = __fadd_rn(gumbel(bits_at(k1, k2, (uint64_t)(r * n + j))), row[j]);
    if (v > best || (v == best && j < best_j)) {
      best = v;
      best_j = j;
    }
  }
  __shared__ float s_val[THREADS];
  __shared__ int64_t s_idx[THREADS];
  s_val[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_j;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const float ov = s_val[threadIdx.x + w];
      const int64_t oj = s_idx[threadIdx.x + w];
      if (ov > s_val[threadIdx.x] || (ov == s_val[threadIdx.x] && oj < s_idx[threadIdx.x])) {
        s_val[threadIdx.x] = ov;
        s_idx[threadIdx.x] = oj;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[r] = (int)(s_idx[0] == INT64_MAX ? 0 : s_idx[0]);
}

}  // namespace

extern "C" {

int threefry_uniform(const void* key, long long n, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  uniform_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const int64_t*)key, (int64_t)n,
                                                             (float*)out);
  return (int)cudaGetLastError();
}

int threefry_categorical(const void* key, int rows, long long n, const void* logits,
                         long long stride, void* out, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  categorical_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (int64_t)n, (const float*)logits, (int64_t)stride, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
