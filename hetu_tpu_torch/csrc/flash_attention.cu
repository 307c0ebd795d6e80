// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (batch, heads, seq, head_dim), causal or not, with an optional additive
// per-key bias. Returns o (the input dtype) and lse = m + log(l) (f32).
//
// Port of the TPU kernel hetu_tpu/kernels/flash_attention.py:_fwd_pallas
// (body _fwd_kernel). What it keeps out of device memory is the same: the
// (S, S) score matrix never exists; a block holds one tile of scores at a
// time and carries the running row max m, row sum l and the unnormalised
// output acc in f32.
//
// Bound on an H100 SXM: 4*B*H*S*S*D flops against reading q, k, v and
// writing o once. At the BERT-base shape (B=32, H=12, S=128, D=64, bf16)
// that is 1.6 GFLOP and 25 MB: 1.6 us at 989 TFLOP/s and 7.5 us at
// 3.35 TB/s, so the bound is the memory. This first kernel computes q.k^T
// and p.v with f32 FMAs on the CUDA cores (67 TFLOP/s peak), not with the
// tensor cores, so it is bound by its own arithmetic, far above the
// memory bound; the design point is to be right and to read q, k and v
// once per block from device memory. wgmma/TMA tiles are later work.
//
// Design. Grid (B*H, ceil(S/64)); 256 threads as a 16x16 grid (ty, tx).
// A block loads its 64 query rows (times scale, as _fwd_kernel does) into
// shared memory once, then streams 64-key tiles of k (stored transposed)
// and v through shared memory. Thread (ty, tx) owns score rows ty+16i and
// key columns tx+16j (i, j < 4), and output rows ty+16i, columns tx+16j
// (j < D/16); the 16 threads of one row are one half-warp, so the row max
// and row sum are half-warp shuffles. bf16 is converted to f32 on load.
//
// Masking follows the reference exactly:
// - k_bias is added to every score column;
// - causal scores above the diagonal are -1e30, not -inf: a fully padded
//   row then degenerates to a uniform softmax, as in the reference, where
//   -inf would give exp(-inf - (-inf)) = NaN;
// - the reference skips, per q block of block_q rows, every key block of
//   block_k keys above the diagonal (ceil bound of _causal_upper_kb). The
//   kernel's own 64x64 tiles differ from the caller's blocks, so each row
//   excludes (as -inf: adds 0 to l) exactly the keys the reference never
//   visits for that row. Only a fully masked causal row can tell the
//   difference, and it then gets the reference's answer.
// - l = max(l, 1e-30) before the divide; lse = m + log(l).
//
// C interface for ctypes: returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a head_dim or dtype it was not built for) and
// launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One past the last key the reference visits for query row `row`.
__device__ __forceinline__ int key_limit(int row, int seq, int causal,
                                         int req_bq, int req_bk) {
  if (!causal) return seq;
  const int q_end = (row / req_bq + 1) * req_bq;
  const int lim = (q_end + req_bk - 1) / req_bk * req_bk;
  return lim < seq ? lim : seq;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kbias,
                 T* __restrict__ o, float* __restrict__ lse, int seq,
                 int heads, float scale, int causal, int req_bq, int req_bk) {
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][D + 1]
  float* KsT = Qs + kBQ * (D + 1);         // [D][kBK + 1]
  float* Vs = KsT + D * (kBK + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;                // [kBQ][kBK + 1]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const T* qp = q + base;
  const T* kp = k + base;
  const T* vp = v + base;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    const float x = row < seq ? to_f32(qp[static_cast<int64_t>(row) * D + d])
                              : 0.0f;
    Qs[r * (D + 1) + d] = x * scale;
  }

  int row[4], lim[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    lim[i] = key_limit(row[i], seq, causal, req_bq, req_bk);
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  const int last_row = (q0 + kBQ < seq ? q0 + kBQ : seq) - 1;
  const int kv_end = key_limit(last_row, seq, causal, req_bq, req_bk);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's KsT/Vs/Ps are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int key = k0 + c;
      const int64_t off = static_cast<int64_t>(key) * D + d;
      KsT[d * (kBK + 1) + c] = key < seq ? to_f32(kp[off]) : 0.0f;
      Vs[c * D + d] = key < seq ? to_f32(vp[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = KsT[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j];
        if (key >= lim[i]) {
          x = -INFINITY;   // a key the reference never visits for this row
        } else {
          if (bp) x = x + bp[key];
          if (causal && key > row[i]) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);   // finite: m starts at -1e30
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum = psum + p;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + psum;   // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = acc[i][j] * alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* op = o + base;
  float* lp = lse + static_cast<int64_t>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li = li + __shfl_xor_sync(0xffffffffu, li, off);
    li = fmaxf(li, 1e-30f);
    if (row[i] < seq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store(op + static_cast<int64_t>(row[i]) * D + tx + 16 * j,
              acc[i][j] / li);
      if (tx == 0) lp[row[i]] = m[i] + logf(li);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kbias,
           void* o, void* lse, int64_t bh, int64_t heads, int64_t seq,
           float scale, int causal, int64_t block_q, int64_t block_k,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block needs the opt-in, which holds for the device that
  // is current; setting it at every launch keeps any device right
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((seq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kbias),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<int>(seq),
      static_cast<int>(heads), scale, causal, static_cast<int>(block_q),
      static_cast<int>(block_k));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int64_t head_dim, const void* q, const void* k, const void* v,
             const void* kbias, void* o, void* lse, int64_t bh, int64_t heads,
             int64_t seq, float scale, int causal, int64_t block_q,
             int64_t block_k, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, kbias, o, lse, bh, heads, seq, scale,
                           causal, block_q, block_k, stream);
    case 32:
      return launch<T, 32>(q, k, v, kbias, o, lse, bh, heads, seq, scale,
                           causal, block_q, block_k, stream);
    case 64:
      return launch<T, 64>(q, k, v, kbias, o, lse, bh, heads, seq, scale,
                           causal, block_q, block_k, stream);
    case 128:
      return launch<T, 128>(q, k, v, kbias, o, lse, bh, heads, seq, scale,
                            causal, block_q, block_k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kbias may be null (no bias).
extern "C" int hetu_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kbias, void* o,
    void* lse, int64_t bh, int64_t heads, int64_t seq, int64_t head_dim,
    float scale, int causal, int64_t block_q, int64_t block_k, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, kbias, o, lse, bh, heads, seq,
                           scale, causal, block_q, block_k, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, kbias, o, lse, bh,
                                   heads, seq, scale, causal, block_q,
                                   block_k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
