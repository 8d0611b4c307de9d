// cuDNN's workspace for one convolution, asked of the card's cuDNN without
// launching anything (the memory pre-flight, analysis/memory.py).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA,
// whose buffer assignment knows their scratch. On the card PyTorch runs a
// convolution through cuDNN's graph API: it asks the heuristics (mode
// INSTANT) for engine configurations of the operation graph, drops those
// whose numerical notes it refuses (non-deterministic ones when cuDNN is
// deterministic, down-converting ones, tensor-core ones for float32 when
// TF32 is off), and runs the first configuration that builds into a plan,
// allocating that plan's workspace through its caching allocator. This
// source asks the same question for the same graph (x, w, y with their
// strides; the convolution's padding, stride and dilation), under the flags
// the port's runs on the card set (cuDNN deterministic, TF32 off), and
// returns the workspace of that first plan. Building a plan compiles or selects an
// engine on the host; no kernel runs and nothing is allocated on the card
// but the cuDNN handle.
//
// Build: nvcc ... -I<cudnn include> <libcudnn.so.9>, the library PyTorch
// loads (distributed_active_learning_tpu_torch/kernels.py).

#include <cudnn.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

cudnnHandle_t handles[64] = {};

#define CK(call)                                  \
  do {                                            \
    cudnnStatus_t st_ = (call);                   \
    if (st_ != CUDNN_STATUS_SUCCESS) return st_;  \
  } while (0)

struct Desc {
  cudnnBackendDescriptor_t d = nullptr;
  ~Desc() {
    if (d) cudnnBackendDestroyDescriptor(d);
  }
};

cudnnStatus_t make_tensor(Desc& t, int64_t uid, cudnnDataType_t dtype, const long long* dims,
                          const long long* strides, int nd) {
  CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_TENSOR_DESCRIPTOR, &t.d));
  std::vector<int64_t> dv(dims, dims + nd), sv(strides, strides + nd);
  int64_t align = 16;
  CK(cudnnBackendSetAttribute(t.d, CUDNN_ATTR_TENSOR_DATA_TYPE, CUDNN_TYPE_DATA_TYPE, 1, &dtype));
  CK(cudnnBackendSetAttribute(t.d, CUDNN_ATTR_TENSOR_DIMENSIONS, CUDNN_TYPE_INT64, nd, dv.data()));
  CK(cudnnBackendSetAttribute(t.d, CUDNN_ATTR_TENSOR_STRIDES, CUDNN_TYPE_INT64, nd, sv.data()));
  CK(cudnnBackendSetAttribute(t.d, CUDNN_ATTR_TENSOR_UNIQUE_ID, CUDNN_TYPE_INT64, 1, &uid));
  CK(cudnnBackendSetAttribute(t.d, CUDNN_ATTR_TENSOR_BYTE_ALIGNMENT, CUDNN_TYPE_INT64, 1, &align));
  return cudnnBackendFinalize(t.d);
}

bool has_note(cudnnBackendDescriptor_t engine, cudnnBackendNumericalNote_t note) {
  cudnnBackendNumericalNote_t notes[CUDNN_NUMERICAL_NOTE_TYPE_COUNT];
  int64_t n = 0;
  if (cudnnBackendGetAttribute(engine, CUDNN_ATTR_ENGINE_NUMERICAL_NOTE,
                               CUDNN_TYPE_NUMERICAL_NOTE, CUDNN_NUMERICAL_NOTE_TYPE_COUNT, &n,
                               notes) != CUDNN_STATUS_SUCCESS)
    return false;
  for (int64_t i = 0; i < n; ++i)
    if (notes[i] == note) return true;
  return false;
}

}  // namespace

extern "C" {

// kind: 0 forward, 1 backward data, 2 backward filter. dtype: 0 float32,
// 1 float16, 2 bfloat16 (the compute type is float32 for all three, as
// PyTorch sets it). Dims and strides in NCHW order (strides give the
// layout), 2 + spatial entries each. Writes the workspace bytes of the first
// accepted plan and the length of the heuristics' list. Returns 0, a
// cudnnStatus_t, or 9000 when no configuration builds.
int cudnn_conv_workspace(int kind, int device, int spatial, const long long* x_dims,
                         const long long* x_strides, const long long* w_dims,
                         const long long* w_strides, const long long* y_dims,
                         const long long* y_strides, const long long* stride,
                         const long long* pad, const long long* dilation, int dtype,
                         long long* workspace, int* n_configs) {
  if (device < 0 || device >= 64) return 9001;
  if (cudaSetDevice(device) != cudaSuccess) return 9002;
  if (!handles[device]) CK(cudnnCreate(&handles[device]));
  cudnnHandle_t handle = handles[device];
  int nd = 2 + spatial;
  cudnnDataType_t dt = dtype == 1 ? CUDNN_DATA_HALF : dtype == 2 ? CUDNN_DATA_BFLOAT16
                                                                 : CUDNN_DATA_FLOAT;
  cudnnDataType_t comp = CUDNN_DATA_FLOAT;
  Desc x, w, y, conv, op, graph, heur;
  CK(make_tensor(x, 'x', dt, x_dims, x_strides, nd));
  CK(make_tensor(w, 'w', dt, w_dims, w_strides, nd));
  CK(make_tensor(y, 'y', dt, y_dims, y_strides, nd));

  std::vector<int64_t> st(stride, stride + spatial), pd(pad, pad + spatial),
      dl(dilation, dilation + spatial);
  int64_t sdims = spatial;
  cudnnConvolutionMode_t mode = CUDNN_CROSS_CORRELATION;
  CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_CONVOLUTION_DESCRIPTOR, &conv.d));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_COMP_TYPE, CUDNN_TYPE_DATA_TYPE, 1,
                              &comp));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_CONV_MODE,
                              CUDNN_TYPE_CONVOLUTION_MODE, 1, &mode));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_SPATIAL_DIMS, CUDNN_TYPE_INT64, 1,
                              &sdims));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_FILTER_STRIDES, CUDNN_TYPE_INT64,
                              spatial, st.data()));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_PRE_PADDINGS, CUDNN_TYPE_INT64,
                              spatial, pd.data()));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_POST_PADDINGS, CUDNN_TYPE_INT64,
                              spatial, pd.data()));
  CK(cudnnBackendSetAttribute(conv.d, CUDNN_ATTR_CONVOLUTION_DILATIONS, CUDNN_TYPE_INT64,
                              spatial, dl.data()));
  CK(cudnnBackendFinalize(conv.d));

  float alpha = 1.0f, beta = 0.0f;
  if (kind == 0) {
    CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_OPERATION_CONVOLUTION_FORWARD_DESCRIPTOR, &op.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_X,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &x.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_W,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &w.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_Y,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &y.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_CONV_DESC,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &conv.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_ALPHA,
                                CUDNN_TYPE_FLOAT, 1, &alpha));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_FORWARD_BETA,
                                CUDNN_TYPE_FLOAT, 1, &beta));
  } else if (kind == 1) {
    CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_OPERATION_CONVOLUTION_BACKWARD_DATA_DESCRIPTOR,
                                    &op.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_DX,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &x.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_W,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &w.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_DY,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &y.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_CONV_DESC,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &conv.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_ALPHA,
                                CUDNN_TYPE_FLOAT, 1, &alpha));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_DATA_BETA,
                                CUDNN_TYPE_FLOAT, 1, &beta));
  } else {
    CK(cudnnBackendCreateDescriptor(
        CUDNN_BACKEND_OPERATION_CONVOLUTION_BACKWARD_FILTER_DESCRIPTOR, &op.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_X,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &x.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_DW,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &w.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_DY,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &y.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_CONV_DESC,
                                CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &conv.d));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_ALPHA,
                                CUDNN_TYPE_FLOAT, 1, &alpha));
    CK(cudnnBackendSetAttribute(op.d, CUDNN_ATTR_OPERATION_CONVOLUTION_BWD_FILTER_BETA,
                                CUDNN_TYPE_FLOAT, 1, &beta));
  }
  CK(cudnnBackendFinalize(op.d));

  CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_OPERATIONGRAPH_DESCRIPTOR, &graph.d));
  CK(cudnnBackendSetAttribute(graph.d, CUDNN_ATTR_OPERATIONGRAPH_OPS,
                              CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &op.d));
  CK(cudnnBackendSetAttribute(graph.d, CUDNN_ATTR_OPERATIONGRAPH_HANDLE, CUDNN_TYPE_HANDLE, 1,
                              &handle));
  CK(cudnnBackendFinalize(graph.d));

  cudnnBackendHeurMode_t heur_mode = CUDNN_HEUR_MODE_INSTANT;
  CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_ENGINEHEUR_DESCRIPTOR, &heur.d));
  CK(cudnnBackendSetAttribute(heur.d, CUDNN_ATTR_ENGINEHEUR_OPERATION_GRAPH,
                              CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &graph.d));
  CK(cudnnBackendSetAttribute(heur.d, CUDNN_ATTR_ENGINEHEUR_MODE, CUDNN_TYPE_HEUR_MODE, 1,
                              &heur_mode));
  CK(cudnnBackendFinalize(heur.d));
  int64_t count = 0;
  CK(cudnnBackendGetAttribute(heur.d, CUDNN_ATTR_ENGINEHEUR_RESULTS,
                              CUDNN_TYPE_BACKEND_DESCRIPTOR, 0, &count, nullptr));
  *n_configs = (int)count;
  std::vector<Desc> cfgs(count);
  std::vector<cudnnBackendDescriptor_t> raw(count);
  for (int64_t i = 0; i < count; ++i) {
    CK(cudnnBackendCreateDescriptor(CUDNN_BACKEND_ENGINECFG_DESCRIPTOR, &cfgs[i].d));
    raw[i] = cfgs[i].d;
  }
  int64_t got = 0;
  CK(cudnnBackendGetAttribute(heur.d, CUDNN_ATTR_ENGINEHEUR_RESULTS,
                              CUDNN_TYPE_BACKEND_DESCRIPTOR, count, &got, raw.data()));
  for (int64_t i = 0; i < got; ++i) {
    Desc engine;
    if (cudnnBackendCreateDescriptor(CUDNN_BACKEND_ENGINE_DESCRIPTOR, &engine.d) !=
        CUDNN_STATUS_SUCCESS)
      continue;
    int64_t ne = 0;
    if (cudnnBackendGetAttribute(raw[i], CUDNN_ATTR_ENGINECFG_ENGINE,
                                 CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &ne, &engine.d) !=
        CUDNN_STATUS_SUCCESS)
      continue;
    // What PyTorch refuses with cuDNN deterministic and TF32 off.
    if (has_note(engine.d, CUDNN_NUMERICAL_NOTE_NONDETERMINISTIC)) continue;
    if (has_note(engine.d, CUDNN_NUMERICAL_NOTE_DOWN_CONVERT_INPUTS)) continue;
    if (dtype == 0 && has_note(engine.d, CUDNN_NUMERICAL_NOTE_TENSOR_CORE)) continue;
    Desc plan;
    if (cudnnBackendCreateDescriptor(CUDNN_BACKEND_EXECUTION_PLAN_DESCRIPTOR, &plan.d) !=
        CUDNN_STATUS_SUCCESS)
      continue;
    if (cudnnBackendSetAttribute(plan.d, CUDNN_ATTR_EXECUTION_PLAN_HANDLE, CUDNN_TYPE_HANDLE, 1,
                                 &handle) != CUDNN_STATUS_SUCCESS ||
        cudnnBackendSetAttribute(plan.d, CUDNN_ATTR_EXECUTION_PLAN_ENGINE_CONFIG,
                                 CUDNN_TYPE_BACKEND_DESCRIPTOR, 1, &raw[i]) !=
            CUDNN_STATUS_SUCCESS ||
        cudnnBackendFinalize(plan.d) != CUDNN_STATUS_SUCCESS)
      continue;
    int64_t ws = 0, nw = 0;
    CK(cudnnBackendGetAttribute(plan.d, CUDNN_ATTR_EXECUTION_PLAN_WORKSPACE_SIZE,
                                CUDNN_TYPE_INT64, 1, &nw, &ws));
    *workspace = (long long)ws;
    return 0;
  }
  return 9000;
}

}  // extern "C"
