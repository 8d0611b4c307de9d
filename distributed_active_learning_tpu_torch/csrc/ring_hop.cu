// One step of the ring top-k merge: the Hopper port of the JAX package's
// ops/ring_topk.py::_hop_kernel (launched by _hop_pallas there, by
// ops/ring_topk.py::_launch_ring_step here).
//
// The TPU kernel signals a barrier semaphore on both ring neighbours, waits
// for theirs, then DMAs its k-row window (k f32 values, k i32 indices) into
// the right neighbour's output buffers over ICI; the ring runs S - 1 such
// hops per shard. Where one process drives every shard the handshake is
// stream order kept by the wrapper (events only between distinct cards),
// and one launch copies every window that the shards on one card send in
// one ring step: a mesh on one card runs one launch per step, a mesh over
// cards one launch per card per step. A receiving buffer on another card is
// written through a peer pointer under unified addressing (peer access is
// enabled once per neighbour pair by ring_hop_enable_peer). Between
// processes the receiving buffer is the neighbour's IPC-mapped window
// (ring_hop_ipc_*, below), and the wrapper's handshake is a stream
// synchronisation and a gloo barrier on each side of the launch.
//
// What bounds it on an H100: a hop reads 8 k bytes and writes 8 k (1,600
// at k = 100), half a nanosecond at 3.35 TB/s, so a step costs its launch
// and the host's enqueue. The design keeps both to one per step: the
// window pointers travel by value in the kernel's parameters (at most
// MAX_WINDOWS a launch), one block copies one window with 16-byte vector
// loads and stores where the four buffers allow it, and the wrapper
// allocates nothing and records no event on one card.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_WINDOWS = 16;
constexpr int THREADS = 128;

struct Windows {
  const float* src_v[MAX_WINDOWS];
  const int* src_i[MAX_WINDOWS];
  float* dst_v[MAX_WINDOWS];
  int* dst_i[MAX_WINDOWS];
};

__global__ void __launch_bounds__(THREADS) ring_step_kernel(const Windows w, int k) {
  const int b = blockIdx.x;
  const float* sv = w.src_v[b];
  const int* si = w.src_i[b];
  float* dv = w.dst_v[b];
  int* di = w.dst_i[b];
  const bool vec = ((reinterpret_cast<uintptr_t>(sv) | reinterpret_cast<uintptr_t>(si) |
                     reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(di)) & 15) == 0;
  const int n_vec = vec ? k / 4 : 0;
  for (int j = threadIdx.x; j < n_vec; j += THREADS) {
    reinterpret_cast<float4*>(dv)[j] = reinterpret_cast<const float4*>(sv)[j];
    reinterpret_cast<int4*>(di)[j] = reinterpret_cast<const int4*>(si)[j];
  }
  for (int j = 4 * n_vec + threadIdx.x; j < k; j += THREADS) {
    dv[j] = sv[j];
    di[j] = si[j];
  }
}

}  // namespace

// Copy n_windows k-row windows in one launch. ptrs holds 4 * n_windows
// pointers: every source's values, then every source's indices, then every
// destination's values, then every destination's indices.
extern "C" int ring_step(void* const* ptrs, int n_windows, int k, void* stream) {
  if (k <= 0 || n_windows <= 0 || n_windows > MAX_WINDOWS) return (int)cudaErrorInvalidValue;
  Windows w = {};
  for (int j = 0; j < n_windows; ++j) {
    w.src_v[j] = static_cast<const float*>(ptrs[j]);
    w.src_i[j] = static_cast<const int*>(ptrs[n_windows + j]);
    w.dst_v[j] = static_cast<float*>(ptrs[2 * n_windows + j]);
    w.dst_i[j] = static_cast<int*>(ptrs[3 * n_windows + j]);
  }
  ring_step_kernel<<<n_windows, THREADS, 0, (cudaStream_t)stream>>>(w, k);
  return (int)cudaGetLastError();
}

// Receive windows shared between processes (CUDA IPC). Each rank of a
// multi-process mesh allocates its receive window with cudaMalloc here (not
// from PyTorch's caching allocator, whose blocks are sub-allocations of a
// base that a handle would name) and exports a cudaIpcMemHandle_t; its left
// neighbour opens the handle and ring_step stores through the mapped
// pointer, as the TPU kernel's remote DMA writes into the neighbour's
// buffer. Between distinct cards the open enables peer access lazily. Each
// function sets `device` current for its call and restores the caller's.

// Allocate `bytes` on `device` and write its IPC handle
// (CUDA_IPC_HANDLE_SIZE bytes) into `handle`.
extern "C" int ring_hop_ipc_alloc(int device, long long bytes, void** ptr, void* handle) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, *ptr);
    if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  }
  cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// Map another process's allocation (its handle) into this one, for stores
// from `device`.
extern "C" int ring_hop_ipc_open(int device, const void* handle, void** ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

extern "C" int ring_hop_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

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
