// Fused linear + softmax cross-entropy for Hopper (sm_90a), forward and
// backward: per row n of h (N, D), the logsumexp over the vocabulary of
// s = h.W^T + b and the target's logit s[target], and the gradients of
// nll = lse - s[target], without the (N, V) logits in device memory.
//
// Forward: port of hetu_tpu/kernels/fused_ce.py:_fused_fwd (body
// _fwd_kernel). Backward: port of _fused_bwd (bodies _prob_grad_tile,
// _bwd_dh_kernel, _bwd_dw_kernel). W comes in either layout: "vd" (V, D),
// the tied-embedding orientation, logits = h.W^T + b; "dv" (D, V), the
// LM-head orientation, logits = h.W + b. Neither is transposed or padded by
// a copy.
//
// Bounds on an H100 SXM at the BERT-base MLM shape (N = 640, V = 30522,
// D = 768, bf16). Forward: 2*N*V*D = 30 GFLOP against reading h, W, b and
// targets once and writing two floats per row, 47 MB: 30 us at 989 TFLOP/s
// and 14 us at 3.35 TB/s, so the bound is the operations. Backward:
// recomputing the logits, dh and dW take 3 * 2*N*V*D = 90 GFLOP (91 us)
// against reading W and writing dW, 94 MB (28 us): the operations again.
// These first kernels compute every product with f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not the tensor cores, so they are bound by their own
// arithmetic; the design point is to be right, to stream W once per row
// block, and to keep the logits in registers and shared memory.
// wgmma/TMA tiles are later work.
//
// Forward design. The vocabulary is split across blocks: at N = 640 a grid
// over 64-row blocks alone would be 10 blocks for 132 SMs. Grid
// (ceil(N/64), n_split); block (rb, sp) sweeps its contiguous run of
// 64-wide vocab tiles and keeps, per row, the online (m, l, tl) that
// _fwd_kernel keeps in VMEM scratch. Each tile's 64x64 logits are a
// register-tiled product over D in chunks of 32, h and W chunks staged in
// shared memory (both transposed to [d][row], bf16 converted to f32 on
// load). Thread (ty, tx) owns rows ty+16i and vocab columns tx+16j
// (i, j < 4); the 16 threads of a row are a half-warp, so the row max is a
// half-warp shuffle, while l and tl stay per thread until the end. Each
// block writes partial (m, l, tl) per row; a second kernel merges the
// splits with the same rescale,
//   M = max m_s, L = sum l_s exp(m_s - M), TL = sum tl_s,
// and writes lse = M + log(max(L, 1e-30)) and tl. Two launches, counted by
// the wrapper as one launch of the kernel.
//
// Backward design. With g = (softmax - onehot) * ct, recomputed from the
// forward's lse as p = exp(s - lse): dh = g.W (g.W^T for "dv"),
// dW = g^T.h (h^T.g for "dv"), db = sum over rows of g. The reference
// recomputes the logits in both of its kernels; here they are computed once
// per vocab chunk and g is kept for that chunk only. The vocabulary is
// walked in chunks of C columns (C a multiple of 64, sized so that the
// N x C f32 slab of g holds at most 16 MB: never the (N, V) logits). Per
// chunk, four launches on the stream, in order:
// - linear_nll_bwd_g_kernel, grid (ceil(N/64), ceil(C/64)): the 64x64
//   logits tile as a register-tiled product (4x4 per thread, operands
//   staged in shared memory in chunks of 32 along D, as in the forward),
//   then g for the tile into the slab;
// - linear_nll_bwd_colsum_kernel: db for the chunk's columns, each a sum
//   over the rows in order;
// - linear_nll_bwd_gemm_kernel for dh += g.W_chunk: 64x64 output tiles,
//   split along the chunk (K) into n_split fixed partial dh buffers so that
//   the N x D output fills the SMs (120 tiles at the MLM shape), each
//   partial accumulated over the chunks in order;
// - linear_nll_bwd_gemm_kernel for the chunk's rows of dW = g^T.h, written
//   in W's dtype and layout (each vocab column belongs to one chunk).
// Last, linear_nll_bwd_dh_sum_kernel sums the partials in a fixed order
// into dh in h's dtype. No float atomics: the result is deterministic. The
// wrapper counts the whole sequence as one launch.
//
// Masking follows the reference: vocab positions >= V (the ragged tail,
// 30522 = 476*64 + 58) score -1e30 in the forward and add nothing to l,
// since every split starts at a real vocab position, and get p = 0 (so
// g = 0) in the backward; the target logit is the score at vpos == target,
// 0 when no position matches. Rows past N (the ragged row block) get g = 0:
// the reference's padded rows with cotangent 0.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches (cudaErrorInvalidValue for a dtype it was not built for) and
// launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;       // rows per block
constexpr int kBV = 64;       // vocab positions per tile
constexpr int kBD = 32;       // depth of one staged chunk
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kDV>
__global__ void __launch_bounds__(kThreads)
linear_nll_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                          const float* __restrict__ bias,
                          const int* __restrict__ targets,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_tl, int n_rows, int depth,
                          int vocab, int tiles_per_split) {
  __shared__ float Hs[kBD][kBN + 1];
  __shared__ float Ws[kBD][kBV + 1];

  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int n_tiles = (vocab + kBV - 1) / kBV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  int tgt[4];
  float m[4], l[4], tl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty + 16 * i;
    tgt[i] = row < n_rows ? targets[row] : -1;
    m[i] = kNegInf;
    l[i] = 0.0f;
    tl[i] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * kBV;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;

    for (int d0 = 0; d0 < depth; d0 += kBD) {
      __syncthreads();   // the previous chunk is consumed
      for (int i = tid; i < kBN * kBD; i += kThreads) {
        const int r = i / kBD, dd = i % kBD;
        const int row = n0 + r, d = d0 + dd;
        Hs[dd][r] = (row < n_rows && d < depth)
                        ? to_f32(h[static_cast<int64_t>(row) * depth + d])
                        : 0.0f;
      }
      if (kDV) {   // W (D, V): consecutive threads take consecutive v
        for (int i = tid; i < kBD * kBV; i += kThreads) {
          const int dd = i / kBV, c = i % kBV;
          const int vp = v0 + c, d = d0 + dd;
          Ws[dd][c] = (vp < vocab && d < depth)
                          ? to_f32(w[static_cast<int64_t>(d) * vocab + vp])
                          : 0.0f;
        }
      } else {     // W (V, D): consecutive threads take consecutive d
        for (int i = tid; i < kBV * kBD; i += kThreads) {
          const int c = i / kBD, dd = i % kBD;
          const int vp = v0 + c, d = d0 + dd;
          Ws[dd][c] = (vp < vocab && d < depth)
                          ? to_f32(w[static_cast<int64_t>(vp) * depth + d])
                          : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kBD; ++dd) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Hs[dd][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[dd][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vp = v0 + tx + 16 * j;
        const float x = vp < vocab ? s[i][j] + bias[vp] : kNegInf;
        if (vp == tgt[i]) tl[i] = tl[i] + x;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) psum = psum + expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + psum;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i], ti = tl[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      li = li + __shfl_xor_sync(0xffffffffu, li, off);
      ti = ti + __shfl_xor_sync(0xffffffffu, ti, off);
    }
    const int row = n0 + ty + 16 * i;
    if (tx == 0 && row < n_rows) {
      const int64_t at = static_cast<int64_t>(split) * n_rows + row;
      part_m[at] = m[i];
      part_l[at] = li;
      part_tl[at] = ti;
    }
  }
}

__global__ void linear_nll_combine_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_tl,
                                          float* __restrict__ lse,
                                          float* __restrict__ tl, int n_rows,
                                          int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_m[static_cast<int64_t>(s) * n_rows + row]);
  float sum = 0.0f, t = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t at = static_cast<int64_t>(s) * n_rows + row;
    sum = sum + part_l[at] * expf(part_m[at] - mx);
    t = t + part_tl[at];
  }
  lse[row] = mx + logf(fmaxf(sum, 1e-30f));
  tl[row] = t;
}

template <typename T, bool kDV>
int launch(const void* h, const void* w, const void* bias,
           const void* targets, void* part, void* lse, void* tl,
           int64_t n_rows, int64_t depth, int64_t vocab,
           int64_t tiles_per_split, int64_t n_split, cudaStream_t stream) {
  float* pm = static_cast<float*>(part);
  float* pl = pm + n_split * n_rows;
  float* pt = pl + n_split * n_rows;
  const dim3 grid(static_cast<unsigned>((n_rows + kBN - 1) / kBN),
                  static_cast<unsigned>(n_split));
  linear_nll_partial_kernel<T, kDV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(targets), pm,
      pl, pt, static_cast<int>(n_rows), static_cast<int>(depth),
      static_cast<int>(vocab), static_cast<int>(tiles_per_split));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_nll_combine_kernel<<<static_cast<unsigned>((n_rows + 255) / 256),
                              256, 0, stream>>>(
      pm, pl, pt, static_cast<float*>(lse), static_cast<float*>(tl),
      static_cast<int>(n_rows), static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kTile = 64;             // output tile of the backward kernels
constexpr int64_t kSlabFloats = 1 << 22;   // the g slab: at most 16 MB

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[i][j] += sum over k in [k_begin, k_end) of A(i0 + ty + 16i, k) *
// B(k, j0 + tx + 16j), with A(i, k) = A[i*a_i + k*a_k] and
// B(k, j) = B[k*b_k + j*b_j]; rows i >= M and columns j >= n_cols read as
// 0. Operands are staged as f32 in chunks of kBD along k into
// As [kBD][kTile + 1] and Bs [kBD][kTile + 1], each loaded along whichever
// of its strides is 1, so that neighbouring threads read neighbouring
// addresses. Begins with a __syncthreads().
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ A, int64_t a_i, int64_t a_k, int M,
    const TB* __restrict__ B, int64_t b_k, int64_t b_j, int n_cols,
    int k_begin, int k_end, int i0, int j0, float* As, float* Bs,
    float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = k_begin; k0 < k_end; k0 += kBD) {
    __syncthreads();   // the previous chunk is consumed
    for (int e = tid; e < kTile * kBD; e += kThreads) {
      const int r = a_k == 1 ? e / kBD : e % kTile;
      const int kk = a_k == 1 ? e % kBD : e / kTile;
      const int i = i0 + r, k = k0 + kk;
      As[kk * (kTile + 1) + r] =
          (i < M && k < k_end) ? to_f32(A[i * a_i + k * a_k]) : 0.0f;
    }
    for (int e = tid; e < kTile * kBD; e += kThreads) {
      const int c = b_j == 1 ? e % kTile : e / kBD;
      const int kk = b_j == 1 ? e / kTile : e % kBD;
      const int j = j0 + c, k = k0 + kk;
      Bs[kk * (kTile + 1) + c] =
          (j < n_cols && k < k_end) ? to_f32(B[k * b_k + j * b_j]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBD; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * (kTile + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * (kTile + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// _prob_grad_tile for one element: (softmax - onehot) * ct, where the
// logit x already holds the bias.
__device__ __forceinline__ float prob_grad(float x, int vp, int tgt,
                                           float lse_r, float ct_r) {
  const float p = expf(x - lse_r);
  return (p - (vp == tgt ? 1.0f : 0.0f)) * ct_r;
}

// g[n][c] for vocab positions c0 + c, c < cw: the logits h.W^T + b of one
// 64x64 tile, then prob_grad, into the slab g (row stride `chunk`).
template <typename T, bool kDV>
__global__ void __launch_bounds__(kThreads)
linear_nll_bwd_g_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const float* __restrict__ bias,
                        const int* __restrict__ targets,
                        const float* __restrict__ lse,
                        const float* __restrict__ ct, float* __restrict__ g,
                        int n_rows, int depth, int vocab, int c0, int cw,
                        int chunk) {
  __shared__ float As[kBD * (kTile + 1)];
  __shared__ float Bs[kBD * (kTile + 1)];
  const int i0 = blockIdx.x * kTile;
  const int j0 = c0 + blockIdx.y * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  // A = h (n, d); B(d, v) = W[v][d] ("vd") or W[d][v] ("dv")
  gemm_tile(h, depth, 1, n_rows, w, kDV ? vocab : 1, kDV ? 1 : depth,
            c0 + cw, 0, depth, i0, j0, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= n_rows) continue;
    const int tgt = targets[row];
    const float lse_r = lse[row], ct_r = ct[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vp = j0 + tx + 16 * j;
      if (vp < c0 + cw)
        g[static_cast<int64_t>(row) * chunk + vp - c0] =
            prob_grad(acc[i][j] + bias[vp], vp, tgt, lse_r, ct_r);
    }
  }
}

// db[c0 + c] = sum over rows of g[n][c], c < cw, the rows in order.
__global__ void linear_nll_bwd_colsum_kernel(const float* __restrict__ g,
                                             float* __restrict__ db,
                                             int n_rows, int c0, int cw,
                                             int chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cw) return;
  float sum = 0.0f;
  for (int n = 0; n < n_rows; ++n)
    sum = sum + g[static_cast<int64_t>(n) * chunk + c];
  db[c0 + c] = sum;
}

// out(i, j) (+)= sum over k of A(i, k) * B(k, j) for i < M, j < n_cols, k
// in split z's range [z*k_per_split, ...) of [0, K); the 64x64 tile
// (blockIdx.x, blockIdx.y) of split z = blockIdx.z goes to
// out + z*o_split, at out[i*o_i + j]. accumulate = 0 stores, 1 adds to
// what out holds. Each output element has one owner.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
linear_nll_bwd_gemm_kernel(const TA* __restrict__ A, int64_t a_i,
                           int64_t a_k, const TB* __restrict__ B,
                           int64_t b_k, int64_t b_j, TC* __restrict__ out,
                           int64_t o_i, int64_t o_split, int M, int n_cols,
                           int K, int k_per_split, int accumulate) {
  __shared__ float As[kBD * (kTile + 1)];
  __shared__ float Bs[kBD * (kTile + 1)];
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k_begin + k_per_split, K);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  gemm_tile(A, a_i, a_k, M, B, b_k, b_j, n_cols, k_begin, k_end, i0, j0, As,
            Bs, acc);
  TC* o = out + blockIdx.z * o_split;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= n_cols) continue;
      TC* at = o + row * o_i + col;
      store(at, accumulate ? to_f32(*at) + acc[i][j] : acc[i][j]);
    }
  }
}

// dh = the sum of the n_split partials, in order, in h's dtype.
template <typename T>
__global__ void linear_nll_bwd_dh_sum_kernel(const float* __restrict__ part,
                                             T* __restrict__ dh,
                                             int64_t n_elem, int n_split) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_elem) return;
  float sum = 0.0f;
  for (int s = 0; s < n_split; ++s) sum = sum + part[s * n_elem + i];
  store(dh + i, sum);
}

inline unsigned tiles(int64_t n) {
  return static_cast<unsigned>((n + kTile - 1) / kTile);
}

template <typename T, bool kDV>
int launch_bwd(const void* h, const void* w, const void* bias,
               const void* targets, const void* lse, const void* ct,
               void* g, void* dh_part, void* dh, void* dw, void* db,
               int64_t n_rows, int64_t depth, int64_t vocab, int64_t chunk,
               int64_t n_split, cudaStream_t stream) {
  const T* ht = static_cast<const T*>(h);
  const T* wt = static_cast<const T*>(w);
  T* dwt = static_cast<T*>(dw);
  float* gs = static_cast<float*>(g);
  float* part = static_cast<float*>(dh_part);
  const int n = static_cast<int>(n_rows), d = static_cast<int>(depth);
  const int v = static_cast<int>(vocab), ch = static_cast<int>(chunk);
  for (int c0 = 0; c0 < v; c0 += ch) {
    const int cw = min(ch, v - c0);
    linear_nll_bwd_g_kernel<T, kDV>
        <<<dim3(tiles(n), tiles(cw)), kThreads, 0, stream>>>(
            ht, wt, static_cast<const float*>(bias),
            static_cast<const int*>(targets), static_cast<const float*>(lse),
            static_cast<const float*>(ct), gs, n, d, v, c0, cw, ch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    linear_nll_bwd_colsum_kernel<<<(cw + 255) / 256, 256, 0, stream>>>(
        gs, static_cast<float*>(db), n, c0, cw, ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dh (n, d) += g (n, c) . W_chunk (c, d)
    const int k_split = (cw + static_cast<int>(n_split) - 1) /
                        static_cast<int>(n_split);
    if (kDV)   // W_chunk (c, d) = W[d][c0 + c]
      linear_nll_bwd_gemm_kernel<float, T, float>
          <<<dim3(tiles(n), tiles(d), static_cast<unsigned>(n_split)),
             kThreads, 0, stream>>>(gs, ch, 1, wt + c0, 1, vocab, part,
                                    depth, n_rows * depth, n, d, cw, k_split,
                                    c0 > 0);
    else       // W_chunk (c, d) = W[c0 + c][d]
      linear_nll_bwd_gemm_kernel<float, T, float>
          <<<dim3(tiles(n), tiles(d), static_cast<unsigned>(n_split)),
             kThreads, 0, stream>>>(gs, ch, 1, wt + c0 * depth, depth, 1,
                                    part, depth, n_rows * depth, n, d, cw,
                                    k_split, c0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kDV)   // dW[d][c0 + c] = sum_n h[n][d] g[n][c]: rows d, columns c
      linear_nll_bwd_gemm_kernel<T, float, T>
          <<<dim3(tiles(d), tiles(cw), 1), kThreads, 0, stream>>>(
              ht, 1, depth, gs, ch, 1, dwt + c0, vocab, 0, d, cw, n, n, 0);
    else       // dW[c0 + c][d] = sum_n g[n][c] h[n][d]: rows c, columns d
      linear_nll_bwd_gemm_kernel<float, T, T>
          <<<dim3(tiles(cw), tiles(d), 1), kThreads, 0, stream>>>(
              gs, 1, ch, ht, depth, 1, dwt + c0 * depth, depth, 0, cw, d, n,
              n, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_elem = n_rows * depth;
  linear_nll_bwd_dh_sum_kernel<T>
      <<<static_cast<unsigned>((n_elem + 255) / 256), 256, 0, stream>>>(
          part, static_cast<T*>(dh), n_elem, static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hetu_linear_nll_tile_width() { return kBV; }

// dtype: 0 = float32, 1 = bfloat16; w_dv: 0 = W (V, D), 1 = W (D, V).
// part: 3 * n_split * n_rows floats of scratch. The splits partition the
// ceil(vocab / 64) vocab tiles into runs of tiles_per_split, none empty.
extern "C" int hetu_fused_linear_nll_fwd(
    const void* h, const void* w, const void* bias, const void* targets,
    void* part, void* lse, void* tl, int64_t n_rows, int64_t depth,
    int64_t vocab, int64_t tiles_per_split, int64_t n_split, int w_dv,
    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_dv)
    return launch<float, true>(h, w, bias, targets, part, lse, tl, n_rows,
                               depth, vocab, tiles_per_split, n_split, s);
  if (dtype == 0)
    return launch<float, false>(h, w, bias, targets, part, lse, tl, n_rows,
                                depth, vocab, tiles_per_split, n_split, s);
  if (dtype == 1 && w_dv)
    return launch<__nv_bfloat16, true>(h, w, bias, targets, part, lse, tl,
                                       n_rows, depth, vocab, tiles_per_split,
                                       n_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(h, w, bias, targets, part, lse, tl,
                                        n_rows, depth, vocab, tiles_per_split,
                                        n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's work split for n_rows x vocab x depth on a card with
// sm_count SMs: out[0] the vocab chunk C (a multiple of 64, at most the
// rounded-up vocabulary, the N x C f32 slab at most kSlabFloats), out[1]
// n_split, the dh partials (so that the dh product's tiles fill about two
// blocks per SM, each split at least 512 columns of the chunk deep). The
// caller allocates the slab (n_rows * C floats) and the partials
// (n_split * n_rows * depth floats).
extern "C" void hetu_linear_nll_bwd_plan(int64_t n_rows, int64_t depth,
                                         int64_t vocab, int64_t sm_count,
                                         int64_t* out) {
  const int64_t vocab_tiles = (vocab + kTile - 1) / kTile;
  int64_t chunk = kSlabFloats / (n_rows > 0 ? n_rows : 1) / kTile;
  chunk = (chunk < 1 ? 1 : (chunk > vocab_tiles ? vocab_tiles : chunk)) *
          kTile;
  const int64_t out_tiles = ((n_rows + kTile - 1) / kTile) *
                            ((depth + kTile - 1) / kTile);
  int64_t n_split = (2 * sm_count + out_tiles - 1) / out_tiles;
  const int64_t deepest = chunk / 512 > 1 ? chunk / 512 : 1;
  out[0] = chunk;
  out[1] = n_split < 1 ? 1 : (n_split > deepest ? deepest : n_split);
}

// dtype: 0 = float32, 1 = bfloat16; w_dv: 0 = W (V, D), 1 = W (D, V).
// lse and ct are (n_rows,) f32; dh and dw are written in the input dtype,
// db (vocab,) in f32. g and dh_part: the scratch of
// hetu_linear_nll_bwd_plan.
extern "C" int hetu_fused_linear_nll_bwd(
    const void* h, const void* w, const void* bias, const void* targets,
    const void* lse, const void* ct, void* g, void* dh_part, void* dh,
    void* dw, void* db, int64_t n_rows, int64_t depth, int64_t vocab,
    int64_t chunk, int64_t n_split, int w_dv, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_dv)
    return launch_bwd<float, true>(h, w, bias, targets, lse, ct, g, dh_part,
                                   dh, dw, db, n_rows, depth, vocab, chunk,
                                   n_split, s);
  if (dtype == 0)
    return launch_bwd<float, false>(h, w, bias, targets, lse, ct, g, dh_part,
                                    dh, dw, db, n_rows, depth, vocab, chunk,
                                    n_split, s);
  if (dtype == 1 && w_dv)
    return launch_bwd<__nv_bfloat16, true>(h, w, bias, targets, lse, ct, g,
                                           dh_part, dh, dw, db, n_rows,
                                           depth, vocab, chunk, n_split, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(h, w, bias, targets, lse, ct, g,
                                            dh_part, dh, dw, db, n_rows,
                                            depth, vocab, chunk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
