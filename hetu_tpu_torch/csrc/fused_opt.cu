// Fused optimizer step kernels for Hopper (sm_90a): SGD and Adam.
//
// Ports of the TPU kernels hetu_tpu/kernels/fused_opt.py:_sgd_pallas and
// :_adam_pallas. Each is one grid-stride elementwise pass over the flat
// parameter: SGD reads p, g and writes p (12 bytes per element); Adam reads
// p, g, m, v and writes p, m, v (28 bytes per element). Both do a handful of
// flops per element, so they are bound by device-memory bytes; the design
// point is a single pass with no intermediate in device memory. The TPU's
// (8, 128) lane view and its zero padding have no counterpart: the loop
// bound masks the tail.
//
// p, m and v are updated IN PLACE (the JAX kernels return new arrays); the
// caller passes tensors autograd does not track. lr and the Adam step count
// t are read from 1-element float32 device tensors, so a step needs no host
// value. t is only read here: blocks run in no order, so a block writing it
// would race the others; the caller computes t + 1 after the launch.
//
// The expression order is that of hetu_tpu/kernels/fused_opt.py:_adam_xla
// and _sgd_xla, and the build passes -fmad=false, so each product is
// rounded where the plain PyTorch version rounds it. (1 - beta) arrives
// precomputed by the caller in double precision and rounded to float, as
// PyTorch and JAX round a Python-float scalar.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launch (0 on success) and launches on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// enough blocks in flight to fill 132 SMs several times over; larger
// tensors are covered by the grid-stride loop
constexpr int64_t kMaxBlocks = 132 * 16;

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                           const float* __restrict__ lr_ptr, float l2reg,
                           int64_t n) {
  const float lr = *lr_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float pv = p[i];
    float gv = g[i];
    if (l2reg > 0.0f) gv = gv + l2reg * pv;
    p[i] = pv - lr * gv;
  }
}

__global__ void adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ v,
                            const float* __restrict__ t_ptr,
                            const float* __restrict__ lr_ptr, float beta1,
                            float beta2, float one_minus_beta1,
                            float one_minus_beta2, float eps,
                            float weight_decay, int64_t n) {
  const float t = *t_ptr + 1.0f;
  const float lr = *lr_ptr;
  const float bc1 = 1.0f - powf(beta1, t);
  const float bc2 = 1.0f - powf(beta2, t);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gv = g[i];
    const float pv = p[i];
    const float mv = beta1 * m[i] + one_minus_beta1 * gv;
    const float vv = beta2 * v[i] + one_minus_beta2 * gv * gv;
    const float m_hat = mv / bc1;
    const float v_hat = vv / bc2;
    float np = pv - lr * m_hat / (sqrtf(v_hat) + eps);
    if (weight_decay > 0.0f) np = np - lr * weight_decay * pv;
    p[i] = np;
    m[i] = mv;
    v[i] = vv;
  }
}

}  // namespace

extern "C" int hetu_fused_sgd(void* p, const void* g, const void* lr,
                              float l2reg, int64_t n, void* stream) {
  sgd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(lr), l2reg, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetu_fused_adam(void* p, const void* g, void* m, void* v,
                               const void* t, const void* lr, float beta1,
                               float beta2, float one_minus_beta1,
                               float one_minus_beta2, float eps,
                               float weight_decay, int64_t n, void* stream) {
  adam_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(t), static_cast<const float*>(lr), beta1, beta2,
      one_minus_beta1, one_minus_beta2, eps, weight_decay, n);
  return static_cast<int>(cudaGetLastError());
}
