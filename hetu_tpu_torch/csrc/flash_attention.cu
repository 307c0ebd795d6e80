// Flash attention for Hopper (sm_90a): online-softmax attention over
// (batch, heads, seq, head_dim), causal or not, with an optional additive
// per-key bias, and its backward.
//
// Forward: port of hetu_tpu/kernels/flash_attention.py:_fwd_pallas (body
// _fwd_kernel). Returns o (the input dtype) and lse = m + log(l) (f32).
// What it keeps out of device memory is the same: the (S, S) score matrix
// never exists; a block holds one tile of scores at a time and carries the
// running row max m, row sum l and the unnormalised output acc in f32.
//
// Backward: port of _bwd_pallas (bodies _bwd_dq_kernel and
// _bwd_dkv_kernel). Given dO, the forward's lse and delta = rowsum(dO * O)
// (f32, computed by the caller before the launch, as the reference computes
// it in XLA), each tile recomputes its probabilities p = exp(s - lse) from
// q and k instead of reading an (S, S) tensor, then
//   dp = dO.V^T, ds = p * (dp - delta) * scale,
//   dq = ds.K, dk = ds^T.Q, dv = p^T.dO.
//
// Bounds on an H100 SXM at the BERT-base shape (B=32, H=12, S=128, D=64,
// bf16). Forward: 4*B*H*S*S*D = 1.6 GFLOP against reading q, k, v and
// writing o once, 25 MB: 1.6 us at 989 TFLOP/s and 7.5 us at 3.35 TB/s, so
// the bound is the memory. Backward: 10*B*H*S*S*D = 4.0 GFLOP (4.1 us)
// against reading q, k, v, o, dO and writing dq, dk, dv, 50 MB (15 us):
// memory again. These first kernels compute every product with f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), not with the tensor cores, so they are
// bound by their own arithmetic, far above the memory bound; the design
// point is to be right and to read each operand tile once per block from
// device memory. wgmma/TMA tiles are later work.
//
// Forward design. Grid (B*H, ceil(S/64)); 256 threads as a 16x16 grid
// (ty, tx). A block loads its 64 query rows (times scale, as _fwd_kernel
// does) into shared memory once, then streams 64-key tiles of k (stored
// transposed) and v through shared memory. Thread (ty, tx) owns score rows
// ty+16i and key columns tx+16j (i, j < 4), and output rows ty+16i, columns
// tx+16j (j < D/16); the 16 threads of one row are one half-warp, so the row
// max and row sum are half-warp shuffles. bf16 is converted to f32 on load.
//
// Backward design. Two kernels, launched back to back and counted by the
// wrapper as one launch; each grid block owns disjoint outputs, so there
// are no float atomics and the result is deterministic.
// - flash_bwd_dq_kernel, grid (B*H, ceil(S/64)): a block owns 64 query
//   rows (q and dO staged once) and loops over 64-key tiles of k and v
//   (stored transposed, [d][key]) up to the rows' last visited key. Per
//   tile: s and dp as 4x4 register tiles per thread, ds to shared memory,
//   then dq += ds.K with K read from the same transposed tile.
// - flash_bwd_dkv_kernel, grid (B*H, ceil(S/64)): a block owns 64 keys (k
//   and v staged once) and loops over 64-row tiles of q and dO (stored
//   transposed), from the first tile whose rows visit these keys (the
//   causal lower bound) on. Per tile: s^T and dp^T per thread, p and ds to
//   shared memory, then dv += p^T.dO and dk += ds^T.Q.
// Shared memory: at head_dim 128 the dq kernel stages 149 KB and the dkv
// kernel 166 KB of f32 tiles, above the 48 KB default; the launch raises
// the block's limit with cudaFuncSetAttribute (the H100 allows 227 KB).
//
// Masking follows the reference exactly, in both directions:
// - k_bias is added to every score column;
// - causal scores above the diagonal are -1e30, not -inf: a fully padded
//   row then degenerates to a uniform softmax, as in the reference, where
//   -inf would give exp(-inf - (-inf)) = NaN;
// - the reference skips, per q block of block_q rows, every key block of
//   block_k keys above the diagonal (ceil bound of _causal_upper_kb); its
//   dkv kernel starts at the matching q block, so both directions visit
//   the same (q block, k block) pairs. The kernels' own 64x64 tiles differ
//   from the caller's blocks, so each row excludes (forward: as -inf, adds
//   0 to l; backward: p = 0) exactly the keys the reference never visits
//   for that row. Only a fully masked row can tell the difference, and it
//   then gets the reference's answer;
// - a fully padded row has s = lse = -1e30 in f32, so the backward's
//   p = exp(s - lse) is 1 for every visited key, not the forward's 1/S:
//   that is the reference's backward, and the kernels compute it as is;
// - l = max(l, 1e-30) before the divide; lse = m + log(l).
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches (or cudaErrorInvalidValue for a head_dim or dtype it was not
// built for) and launches on the given stream.

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


// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (D + 1) + 2 * D * (kBK + 1) + kBQ * (kBK + 1));
}

template <int D>
constexpr size_t bwd_dkv_smem_bytes() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * D * (kBQ + 1) +
                          2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ kbias, T* __restrict__ dq,
                    int seq, int heads, float scale, int causal, int req_bq,
                    int req_bk) {
  constexpr int DJ = D / 16;   // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][D + 1]
  float* dOs = Qs + kBQ * (D + 1);         // [kBQ][D + 1]
  float* KsT = dOs + kBQ * (D + 1);        // [D][kBK + 1]
  float* VsT = KsT + D * (kBK + 1);        // [D][kBK + 1]
  float* DSs = VsT + D * (kBK + 1);        // [kBQ][kBK + 1]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const T* kp = k + base;
  const T* vp = v + base;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    const bool in = row < seq;
    const int64_t off = base + static_cast<int64_t>(row) * D + d;
    Qs[r * (D + 1) + d] = in ? to_f32(q[off]) : 0.0f;
    dOs[r * (D + 1) + d] = in ? to_f32(dout[off]) : 0.0f;
  }

  int row[4], lim[4];
  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    lim[i] = key_limit(row[i], seq, causal, req_bq, req_bk);
    const bool in = row[i] < seq;
    const int64_t at = static_cast<int64_t>(bh) * seq + row[i];
    lse_r[i] = in ? lse[at] : 0.0f;
    delta_r[i] = in ? delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  const int last_row = (q0 + kBQ < seq ? q0 + kBQ : seq) - 1;
  const int kv_end = key_limit(last_row, seq, causal, req_bq, req_bk);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's KsT/VsT/DSs are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int key = k0 + c;
      const int64_t off = static_cast<int64_t>(key) * D + d;
      KsT[d * (kBK + 1) + c] = key < seq ? to_f32(kp[off]) : 0.0f;
      VsT[d * (kBK + 1) + c] = key < seq ? to_f32(vp[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        g[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = KsT[d * (kBK + 1) + tx + 16 * j];
        c[j] = VsT[d * (kBK + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.0f;   // a key the reference never visits for this row
        if (key < lim[i]) {
          float x = s[i][j] * scale;
          if (bp) x = x + bp[key];
          if (causal && key > row[i]) x = kNegInf;
          const float p = expf(x - lse_r[i]);
          ds = p * (dp[i][j] - delta_r[i]) * scale;
        }
        DSs[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = DSs[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = KsT[(tx + 16 * j) * (kBK + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= seq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(dq + base + static_cast<int64_t>(row[i]) * D + tx + 16 * j,
            acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kbias, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, float scale,
                     int causal, int req_bq, int req_bk) {
  constexpr int DJ = D / 16;   // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);          // [kBK][D + 1]
  float* QsT = Vs + kBK * (D + 1);         // [D][kBQ + 1]
  float* dOsT = QsT + D * (kBQ + 1);       // [D][kBQ + 1]
  float* Ps = dOsT + D * (kBQ + 1);        // [kBK][kBQ + 1]
  float* DSs = Ps + kBK * (kBQ + 1);       // [kBK][kBQ + 1]
  float* lse_s = DSs + kBK * (kBQ + 1);    // [kBQ]
  float* delta_s = lse_s + kBQ;            // [kBQ]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const T* qp = q + base;
  const T* dop = dout + base;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const int key = k0 + c;
    const bool in = key < seq;
    const int64_t off = base + static_cast<int64_t>(key) * D + d;
    Ks[c * (D + 1) + d] = in ? to_f32(k[off]) : 0.0f;
    Vs[c * (D + 1) + d] = in ? to_f32(v[off]) : 0.0f;
  }

  int key[4];
  float kb[4], acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + ty + 16 * i;
    kb[i] = (bp && key[i] < seq) ? bp[key[i]] : 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;
  }
  // causal: the reference's dkv kernel starts at q block k_start // block_q
  // of the caller's k block holding this tile's first key; earlier rows
  // visit none of these keys
  int q_begin = 0;
  if (causal) {
    const int ref_k_start = k0 / req_bk * req_bk;
    q_begin = ref_k_start / req_bq * req_bq / kBQ * kBQ;
  }

  for (int r0 = q_begin; r0 < seq; r0 += kBQ) {
    __syncthreads();   // the previous tile's QsT/dOsT/Ps/DSs are consumed
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int qrow = r0 + r;
      const int64_t off = static_cast<int64_t>(qrow) * D + d;
      QsT[d * (kBQ + 1) + r] = qrow < seq ? to_f32(qp[off]) : 0.0f;
      dOsT[d * (kBQ + 1) + r] = qrow < seq ? to_f32(dop[off]) : 0.0f;
    }
    if (tid < kBQ) {
      const int qrow = r0 + tid;
      const int64_t at = static_cast<int64_t>(bh) * seq + qrow;
      lse_s[tid] = qrow < seq ? lse[at] : 0.0f;
      delta_s[tid] = qrow < seq ? delta[at] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns query rows
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], e[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty + 16 * i) * (D + 1) + d];
        e[i] = Vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = QsT[d * (kBQ + 1) + tx + 16 * j];
        g[j] = dOsT[d * (kBQ + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(e[i], g[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qrow = r0 + c;
        float p = 0.0f, ds = 0.0f;
        // key_limit <= seq, so this also drops keys and rows past the end
        if (qrow < seq &&
            key[i] < key_limit(qrow, seq, causal, req_bq, req_bk)) {
          float x = st[i][j] * scale;
          if (bp) x = x + kb[i];
          if (causal && key[i] > qrow) x = kNegInf;
          p = expf(x - lse_s[c]);
          ds = p * (dpt[i][j] - delta_s[c]) * scale;
        }
        Ps[(ty + 16 * i) * (kBQ + 1) + c] = p;
        DSs[(ty + 16 * i) * (kBQ + 1) + c] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pw[4], dw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pw[i] = Ps[(ty + 16 * i) * (kBQ + 1) + r];
        dw[i] = DSs[(ty + 16 * i) * (kBQ + 1) + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = dOsT[(tx + 16 * j) * (kBQ + 1) + r];
        const float qv = QsT[(tx + 16 * j) * (kBQ + 1) + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][j] = fmaf(pw[i], dov, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dw[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (key[i] >= seq) continue;
    const int64_t off = base + static_cast<int64_t>(key[i]) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dk + off + tx + 16 * j, acc_dk[i][j]);
      store(dv + off + tx + 16 * j, acc_dv[i][j]);
    }
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kbias,
               void* dq, void* dk, void* dv, int64_t bh, int64_t heads,
               int64_t seq, float scale, int causal, int64_t block_q,
               int64_t block_k, cudaStream_t stream) {
  constexpr size_t smem_dq = bwd_dq_smem_bytes<D>();
  constexpr size_t smem_dkv = bwd_dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  const float* bf = static_cast<const float*>(kbias);
  const int s = static_cast<int>(seq), h = static_cast<int>(heads);
  const int bq = static_cast<int>(block_q), bk = static_cast<int>(block_k);
  const dim3 grid_q(static_cast<unsigned>(bh),
                    static_cast<unsigned>((seq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, lf, df, bf, static_cast<T*>(dq), s, h, scale, causal,
      bq, bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(static_cast<unsigned>(bh),
                    static_cast<unsigned>((seq + kBK - 1) / kBK));
  flash_bwd_dkv_kernel<T, D><<<grid_k, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lf, df, bf, static_cast<T*>(dk), static_cast<T*>(dv),
      s, h, scale, causal, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_d(int64_t head_dim, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, const void* kbias, void* dq, void* dk,
                 void* dv, int64_t bh, int64_t heads, int64_t seq,
                 float scale, int causal, int64_t block_q, int64_t block_k,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, dout, lse, delta, kbias, dq, dk, dv,
                               bh, heads, seq, scale, causal, block_q,
                               block_k, stream);
    case 32:
      return launch_bwd<T, 32>(q, k, v, dout, lse, delta, kbias, dq, dk, dv,
                               bh, heads, seq, scale, causal, block_q,
                               block_k, stream);
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, lse, delta, kbias, dq, dk, dv,
                               bh, heads, seq, scale, causal, block_q,
                               block_k, stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, dout, lse, delta, kbias, dq, dk,
                                dv, bh, heads, seq, scale, causal, block_q,
                                block_k, stream);
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

// dtype: 0 = float32, 1 = bfloat16. kbias may be null (no bias). lse and
// delta are (B*H, S) f32; dq, dk and dv are written in the input dtype.
extern "C" int hetu_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kbias, void* dq,
    void* dk, void* dv, int64_t bh, int64_t heads, int64_t seq,
    int64_t head_dim, float scale, int causal, int64_t block_q,
    int64_t block_k, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_d<float>(head_dim, q, k, v, dout, lse, delta, kbias,
                               dq, dk, dv, bh, heads, seq, scale, causal,
                               block_q, block_k, s);
  if (dtype == 1)
    return launch_bwd_d<__nv_bfloat16>(head_dim, q, k, v, dout, lse, delta,
                                       kbias, dq, dk, dv, bh, heads, seq,
                                       scale, causal, block_q, block_k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
