// One hop of the ring top-k merge: the Hopper port of the JAX package's
// ops/ring_topk.py::_hop_kernel (launched by _hop_pallas there, by
// ops/ring_topk.py::_launch_hop here).
//
// The TPU kernel signals a barrier semaphore on both ring neighbours, waits
// for theirs, then DMAs its k-row window (k f32 values, k i32 indices) into
// the right neighbour's output buffers over ICI. Here one process drives
// every shard, so the handshake is stream ordering done by the wrapper
// (events on the sender's and the receiver's streams), and the copy is this
// kernel: it runs on the sender's device and stream and stores the window
// straight into buffers that live on the receiver's device, through a peer
// pointer under unified addressing on distinct cards (peer access is enabled
// once per neighbour pair by ring_hop_enable_peer), or on the same card when
// the mesh repeats it.
//
// What bounds it on an H100: it reads 8 k bytes and writes 8 k (1,600 at
// k = 100), half a nanosecond at 3.35 TB/s, so its time is launch and
// enqueue overhead (PERF.md has the measurement); one thread per row, one
// block per 256 rows.

#include <cuda_runtime.h>

namespace {

__global__ void ring_hop_kernel(const float* __restrict__ src_v, const int* __restrict__ src_i,
                                float* __restrict__ dst_v, int* __restrict__ dst_i, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < k) {
    dst_v[j] = src_v[j];
    dst_i[j] = src_i[j];
  }
}

}  // namespace

extern "C" int ring_hop(const float* src_v, const int* src_i, float* dst_v, int* dst_i, int k,
                        void* stream) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  ring_hop_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      src_v, src_i, dst_v, dst_i, k);
  return (int)cudaGetLastError();
}

// Let `device` store into `peer`'s memory. Returns 0 when it can (or already
// could), cudaErrorPeerAccessUnsupported when the cards cannot reach each
// other. The caller's current device is restored.
extern "C" int ring_hop_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it leaves as the last error
    err = cudaSuccess;
  }
  cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
