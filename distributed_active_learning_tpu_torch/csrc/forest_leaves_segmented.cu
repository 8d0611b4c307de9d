// Per-tree leaf values with feature-segmented node slots: the Hopper port of
// the kernel-variant sweep's benches/pallas_variants.py::_kernel_segmented,
// launched by benches/pallas_variants.py::_launch_segmented of the port.
//
// The function is forest_leaves.cu's with another operand layout: the node of
// tree t that is the r-th to split on feature f lives at slot k = f * S + r
// (S slots per feature, 32 features, so 32 S slots), and slot k compares
// feature k / S of the row against thr[t][k]: there is no feature-id array
// and no gather through one. Empty slots hold -inf and compare false. The
// path masks run over the 32 S slots (32 slots to a word, so S words a
// leaf), and the leaf payload is hi + lo, two bf16
// planes accumulated over the hits and then added.
//
// x arrives transposed, xT[32][n_pad] in bf16. The grid is (row tiles of bn
// rows) x (tree tiles of bt trees), the row tile slow; a block of 128 threads
// sweeps its tile's rows, one row a thread at a time, and stages one tree of
// its tile after the other into shared memory. A thread builds its row's
// compare bits feature by feature (one load of xT per feature, S compares)
// into shared memory, bits[w][thread], since S words do not fit registers;
// then, per leaf, it visits only the words where a mask is nonzero (a heap
// tree's leaf has depth ancestors, so at most depth words of S). The masks
// themselves stay in device memory, every thread of a warp reading the same
// word (a broadcast out of L1): staged into shared memory they leave room for
// one block a multiprocessor at S = 60, which ran slower on an H100. What
// bounds it: those popcounts over all leaves of every tree, as
// forest_leaves.cu.

#include "forest_eval.cuh"

namespace {

constexpr int MAX_S = 256;               // words of compare bits per row: 32 S <= 8192 slots
constexpr size_t SMEM_LIMIT = 200 * 1024;  // of the 227 KB a block may ask for

struct Seg {
  const uint16_t* xT;     // [32, n_pad] bf16 bits
  const float* thr;       // [t_pad, 32 S]
  const uint32_t* plus;   // [t_pad, L, S]
  const uint32_t* minus;  // [t_pad, L, S]
  const float* tgt;       // [t_pad, L]
  const uint16_t* hi;     // [t_pad, L] bf16 bits
  const uint16_t* lo;     // [t_pad, L] bf16 bits
  int n, n_pad, T, L, S, bn, bt;
};

__device__ inline float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__host__ __device__ inline int nz_words(int S) { return (S + 31) / 32; }

__host__ __device__ inline size_t seg_smem_bytes(int L, int S) {
  size_t b = dal::align16(size_t(32) * S * sizeof(float));                   // thr
  b += 3 * dal::align16(size_t(L) * sizeof(float));                          // tgt, vhi, vlo
  b += dal::align16(size_t(L) * nz_words(S) * sizeof(uint32_t));             // nz
  b += dal::align16(size_t(S) * dal::ROWS * sizeof(uint32_t));               // bits
  return b;
}

__global__ void __launch_bounds__(dal::ROWS) forest_leaves_segmented_kernel(
    Seg G, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = G.L, S = G.S, slots = 32 * S, NZ = nz_words(S);
  size_t o = 0;
  float* thr = reinterpret_cast<float*>(smem_raw + o);       o += dal::align16(size_t(slots) * 4);
  float* tgt = reinterpret_cast<float*>(smem_raw + o);       o += dal::align16(size_t(L) * 4);
  float* vhi = reinterpret_cast<float*>(smem_raw + o);       o += dal::align16(size_t(L) * 4);
  float* vlo = reinterpret_cast<float*>(smem_raw + o);       o += dal::align16(size_t(L) * 4);
  uint32_t* nz = reinterpret_cast<uint32_t*>(smem_raw + o);  o += dal::align16(size_t(L) * NZ * 4);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_raw + o);

  const int tree_tiles = (G.T + G.bt - 1) / G.bt;
  const int ti = blockIdx.x % tree_tiles;
  const int row0 = (blockIdx.x / tree_tiles) * G.bn;
  const int tid = threadIdx.x;

  for (int tt = 0; tt < G.bt; ++tt) {
    const int t = ti * G.bt + tt;
    if (t >= G.T) break;  // the padded trees of the last tile give no output
    __syncthreads();
    for (int k = tid; k < slots; k += blockDim.x) thr[k] = G.thr[(size_t)t * slots + k];
    const uint32_t* __restrict__ plus = G.plus + (size_t)t * L * S;
    const uint32_t* __restrict__ minus = G.minus + (size_t)t * L * S;
    for (int l = tid; l < L; l += blockDim.x) {
      const size_t k = (size_t)t * L + l;
      tgt[l] = G.tgt[k];
      vhi[l] = bf16_bits_to_float(G.hi[k]);
      vlo[l] = bf16_bits_to_float(G.lo[k]);
      for (int g = 0; g < NZ; ++g) {
        uint32_t any = 0u;
        for (int w = 32 * g; w < S && w < 32 * g + 32; ++w) {
          const size_t q = ((size_t)t * L + l) * S + w;
          any |= (uint32_t)((G.plus[q] | G.minus[q]) != 0u) << (w - 32 * g);
        }
        nz[l * NZ + g] = any;
      }
    }
    __syncthreads();
    for (int r = tid; r < G.bn; r += blockDim.x) {
      const int row = row0 + r;
      if (row >= G.n) break;
      // Compare bits, slot k = f * S + j, packed 32 slots to a word.
      uint32_t word = 0u;
      int k = 0;
      for (int f = 0; f < 32; ++f) {
        const float xv = bf16_bits_to_float(G.xT[(size_t)f * G.n_pad + row]);
        for (int j = 0; j < S; ++j, ++k) {
          word |= (uint32_t)(xv <= thr[k]) << (k & 31);
          if ((k & 31) == 31) {
            bits[(k >> 5) * dal::ROWS + tid] = word;
            word = 0u;
          }
        }
      }
      float acc_hi = 0.0f, acc_lo = 0.0f;
      for (int l = 0; l < L; ++l) {
        const uint32_t* p = plus + l * S;
        const uint32_t* m = minus + l * S;
        int count = 0;
        for (int g = 0; g < NZ; ++g) {
          for (uint32_t rest = nz[l * NZ + g]; rest; rest &= rest - 1) {
            const int w = 32 * g + __ffs(rest) - 1;
            const uint32_t c = bits[w * dal::ROWS + tid];
            count += __popc(c & p[w]) - __popc(c & m[w]);
          }
        }
        if ((float)count == tgt[l]) {
          acc_hi += vhi[l];
          acc_lo += vlo[l];
        }
      }
      out[(size_t)t * G.n + row] = acc_hi + acc_lo;
    }
  }
}

}  // namespace

extern "C" int forest_leaves_segmented(
    const uint16_t* xT, int n, int n_pad,
    const float* thr, const uint32_t* plus, const uint32_t* minus,
    const float* tgt, const uint16_t* hi, const uint16_t* lo,
    int T, int L, int S, int bn, int bt, float* out, void* stream) {
  if (S < 1 || S > MAX_S || n <= 0 || T <= 0 || L <= 0 || bn <= 0 || bt <= 0 ||
      n_pad % bn != 0 || n_pad < n) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = seg_smem_bytes(L, S);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Seg G{xT, thr, plus, minus, tgt, hi, lo, n, n_pad, T, L, S, bn, bt};
  cudaError_t err = cudaFuncSetAttribute(
      forest_leaves_segmented_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)(n_pad / bn) * ((T + bt - 1) / bt);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  forest_leaves_segmented_kernel<<<(unsigned)blocks, dal::ROWS, smem, (cudaStream_t)stream>>>(G, out);
  return (int)cudaGetLastError();
}
