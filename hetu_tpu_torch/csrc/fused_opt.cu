// Fused optimizer step kernels for Hopper (sm_90a): SGD and Adam over a
// group of tensors, one launch for up to kMaxTensors of them.
//
// Ports of the TPU kernels hetu_tpu/kernels/fused_opt.py:_sgd_pallas and
// :_adam_pallas, which apply the rule to one parameter per call. The
// function per element is theirs; the TPU's (8, 128) lane view and its zero
// padding have no counterpart here.
//
// Bound: SGD reads p, g and writes p (12 bytes per element); Adam reads p,
// g, m, v and writes p, m, v (28 bytes per element). Both do a handful of
// flops per element, so device memory bounds them: 12 or 28 bytes per
// element at 3.35 TB/s on an H100 SXM. At a model's small parameters the
// launch costs more than the bytes.
//
// What the design does about it:
// - One launch per optimizer apply. The tensors' pointers and their split
//   travel in a struct passed BY VALUE as the kernel's argument (at most
//   kMaxTensors tensors, the struct kept within the 4 KB kernel-parameter
//   limit by a static_assert): no table is copied to the device, and the
//   launch can be captured in a CUDA graph. A larger group takes one launch
//   per kMaxTensors tensors.
// - A persistent grid of at most kBlocksPerSm blocks an SM walks the
//   launch's tensors in order, with a grid-stride loop inside each.
//   Indices are int64_t: a CTR table holds more than 2^31 elements.
// - 16-byte accesses: a tensor whose pointers are all 16-byte aligned runs
//   its body as float4 loads and stores, kUnroll vectors per thread loaded
//   before the first is stored, so several loads are in flight; a scalar
//   loop in the same kernel covers its last n mod 4 elements, and the
//   whole of a tensor with a misaligned pointer (a view at an odd offset).
// The split (per tensor: its count of float4 vectors, and the offset and
// length of its scalar part; the launches, as ranges of tensors) is made in
// Python (kernels/fused_opt.py:opt_plan). The C entries launch it as given
// and refuse a plan made for another kMaxTensors.
//
// p, m and v are updated IN PLACE (the JAX kernels return new arrays); the
// caller passes tensors autograd does not track. lr and each tensor's Adam
// step count t are read from 1-element float32 device tensors, so a step
// needs no host value. t is only read here: blocks run in no order, so a
// block writing it would race the others; the caller computes t + 1 after
// the launch.
//
// The expression order is that of hetu_tpu/kernels/fused_opt.py:_adam_xla
// and _sgd_xla, per element, and the build passes -fmad=false, so each
// product is rounded where the plain PyTorch version rounds it. (1 - beta)
// arrives precomputed by the caller in double precision and rounded to
// float, as PyTorch and JAX round a Python-float scalar. Adam's bias
// corrections come from each tensor's own t.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launch (0 on success), or cudaErrorInvalidValue for a plan it refuses
// without launching, and launches on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// tensors one launch takes; kernels/fused_opt.py:MAX_TENSORS must match
constexpr int kMaxTensors = 48;
// float4 vectors a thread loads before it stores: SGD loads two arrays,
// Adam four, so each keeps 8 vectors in flight per thread
constexpr int kSgdUnroll = 4;
constexpr int kAdamUnroll = 2;
// the persistent grid's cap, in blocks an SM (2, 4 and 8 timed on an H100:
// within 0.4 % of each other for SGD at 2^28 elements; Adam 4-5 % slower at
// 2 on a model's small parameters)
constexpr int kBlocksPerSm = 4;

// one tensor's split: n_vec float4 vectors from its start, then the scalar
// elements [tail_off, tail_off + tail_len)
struct Span {
  int64_t n_vec, tail_off, tail_len;
};

struct SgdGroup {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  Span span[kMaxTensors];
  int n;
};

struct AdamGroup {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* t[kMaxTensors];
  Span span[kMaxTensors];
  int n;
};

// the group and the kernels' other arguments (at most 64 bytes) within the
// 4 KB a kernel's parameters may take
static_assert(sizeof(SgdGroup) + 64 <= 4096, "SgdGroup exceeds 4 KB");
static_assert(sizeof(AdamGroup) + 64 <= 4096, "AdamGroup exceeds 4 KB");

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// blocks that cover the largest tensor's vector part in one round of
// kUnroll vectors a thread, and its scalar part, capped at kBlocksPerSm
// blocks an SM of the current device
template <int kUnroll>
int grid_for(const Span* span, int n) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t max_blocks = static_cast<int64_t>(kBlocksPerSm) *
                             (sms > 0 ? sms : 1);
  int64_t need = 1;
  for (int k = 0; k < n; ++k) {
    const int64_t a = ceil_div(span[k].n_vec, kUnroll * kThreads);
    const int64_t b = ceil_div(span[k].tail_len, kThreads);
    need = a > need ? a : need;
    need = b > need ? b : need;
  }
  return static_cast<int>(need < max_blocks ? need : max_blocks);
}

__device__ __forceinline__ float sgd_update(float pv, float gv, float lr,
                                            float l2reg) {
  if (l2reg > 0.0f) gv = gv + l2reg * pv;
  return pv - lr * gv;
}

__global__ void __launch_bounds__(kThreads)
    sgd_kernel(const SgdGroup grp, const float* __restrict__ lr_ptr,
               float l2reg) {
  const float lr = *lr_ptr;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int k = 0; k < grp.n; ++k) {
    float* __restrict__ p = grp.p[k];
    const float* __restrict__ g = grp.g[k];
    const Span s = grp.span[k];
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t base = tid; base < s.n_vec; base += kSgdUnroll * stride) {
      float4 pv[kSgdUnroll], gv[kSgdUnroll];
#pragma unroll
      for (int u = 0; u < kSgdUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < s.n_vec) {
          pv[u] = p4[i];
          gv[u] = g4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kSgdUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < s.n_vec) {
          p4[i] = make_float4(sgd_update(pv[u].x, gv[u].x, lr, l2reg),
                              sgd_update(pv[u].y, gv[u].y, lr, l2reg),
                              sgd_update(pv[u].z, gv[u].z, lr, l2reg),
                              sgd_update(pv[u].w, gv[u].w, lr, l2reg));
        }
      }
    }
    for (int64_t i = tid; i < s.tail_len; i += stride) {
      const int64_t j = s.tail_off + i;
      p[j] = sgd_update(p[j], g[j], lr, l2reg);
    }
  }
}

struct AdamScalars {
  float lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps,
      weight_decay, bc1, bc2;
};

// one element: p, m, v updated in place
__device__ __forceinline__ void adam_update(float& p, float gv, float& m,
                                            float& v, const AdamScalars& c) {
  const float pv = p;
  const float mv = c.beta1 * m + c.one_minus_beta1 * gv;
  const float vv = c.beta2 * v + c.one_minus_beta2 * gv * gv;
  const float m_hat = mv / c.bc1;
  const float v_hat = vv / c.bc2;
  float np = pv - c.lr * m_hat / (sqrtf(v_hat) + c.eps);
  if (c.weight_decay > 0.0f) np = np - c.lr * c.weight_decay * pv;
  p = np;
  m = mv;
  v = vv;
}

__device__ __forceinline__ void adam_update4(float4& p, const float4& g,
                                             float4& m, float4& v,
                                             const AdamScalars& c) {
  adam_update(p.x, g.x, m.x, v.x, c);
  adam_update(p.y, g.y, m.y, v.y, c);
  adam_update(p.z, g.z, m.z, v.z, c);
  adam_update(p.w, g.w, m.w, v.w, c);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const AdamGroup grp, const float* __restrict__ lr_ptr,
                float beta1, float beta2, float one_minus_beta1,
                float one_minus_beta2, float eps, float weight_decay) {
  AdamScalars c{*lr_ptr, beta1, beta2, one_minus_beta1, one_minus_beta2,
                eps, weight_decay, 0.0f, 0.0f};
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int k = 0; k < grp.n; ++k) {
    const float t = *grp.t[k] + 1.0f;
    c.bc1 = 1.0f - powf(beta1, t);
    c.bc2 = 1.0f - powf(beta2, t);
    float* __restrict__ p = grp.p[k];
    const float* __restrict__ g = grp.g[k];
    float* __restrict__ m = grp.m[k];
    float* __restrict__ v = grp.v[k];
    const Span s = grp.span[k];
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t base = tid; base < s.n_vec; base += kAdamUnroll * stride) {
      float4 pv[kAdamUnroll], gv[kAdamUnroll], mv[kAdamUnroll],
          vv[kAdamUnroll];
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < s.n_vec) {
          pv[u] = p4[i];
          gv[u] = g4[i];
          mv[u] = m4[i];
          vv[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < s.n_vec) {
          adam_update4(pv[u], gv[u], mv[u], vv[u], c);
          p4[i] = pv[u];
          m4[i] = mv[u];
          v4[i] = vv[u];
        }
      }
    }
    for (int64_t i = tid; i < s.tail_len; i += stride) {
      const int64_t j = s.tail_off + i;
      float pj = p[j], mj = m[j], vj = v[j];
      adam_update(pj, g[j], mj, vj, c);
      p[j] = pj;
      m[j] = mj;
      v[j] = vj;
    }
  }
}

// the launch's tensors [first, first + count) of the plan's arrays, or
// false for a plan this source did not make
bool accept(int first, int count, int max_tensors) {
  return max_tensors == kMaxTensors && first >= 0 && count >= 1 &&
         count <= kMaxTensors;
}

void fill_spans(Span* span, const int64_t* n_vec, const int64_t* tail_off,
                const int64_t* tail_len, int first, int count) {
  for (int k = 0; k < count; ++k) {
    span[k] = Span{n_vec[first + k], tail_off[first + k],
                   tail_len[first + k]};
  }
}

}  // namespace

extern "C" int hetu_fused_sgd_multi(void* const* p, void* const* g,
                                    const void* lr, float l2reg,
                                    const int64_t* n_vec,
                                    const int64_t* tail_off,
                                    const int64_t* tail_len, int first,
                                    int count, int max_tensors,
                                    void* stream) {
  if (!accept(first, count, max_tensors)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SgdGroup grp = {};
  grp.n = count;
  for (int k = 0; k < count; ++k) {
    grp.p[k] = static_cast<float*>(p[first + k]);
    grp.g[k] = static_cast<const float*>(g[first + k]);
  }
  fill_spans(grp.span, n_vec, tail_off, tail_len, first, count);
  sgd_kernel<<<grid_for<kSgdUnroll>(grp.span, count), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      grp, static_cast<const float*>(lr), l2reg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetu_fused_adam_multi(
    void* const* p, void* const* g, void* const* m, void* const* v,
    void* const* t, const void* lr, float beta1, float beta2,
    float one_minus_beta1, float one_minus_beta2, float eps,
    float weight_decay, const int64_t* n_vec, const int64_t* tail_off,
    const int64_t* tail_len, int first, int count, int max_tensors,
    void* stream) {
  if (!accept(first, count, max_tensors)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AdamGroup grp = {};
  grp.n = count;
  for (int k = 0; k < count; ++k) {
    grp.p[k] = static_cast<float*>(p[first + k]);
    grp.g[k] = static_cast<const float*>(g[first + k]);
    grp.m[k] = static_cast<float*>(m[first + k]);
    grp.v[k] = static_cast<float*>(v[first + k]);
    grp.t[k] = static_cast<const float*>(t[first + k]);
  }
  fill_spans(grp.span, n_vec, tail_off, tail_len, first, count);
  adam_kernel<<<grid_for<kAdamUnroll>(grp.span, count), kThreads,
                0, static_cast<cudaStream_t>(stream)>>>(
      grp, static_cast<const float*>(lr), beta1, beta2, one_minus_beta1,
      one_minus_beta2, eps, weight_decay);
  return static_cast<int>(cudaGetLastError());
}
