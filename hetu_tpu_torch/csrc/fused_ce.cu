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
//
// Forward design. The vocabulary is split across blocks: at N = 640 a
// grid over row blocks alone would be 5 to 10 blocks for 132 SMs. Grid
// (row blocks, n_split); block (rb, sp) sweeps its contiguous run of vocab
// tiles and keeps, per row, the online (m, l, tl) that _fwd_kernel keeps
// in VMEM scratch. The split is the wrapper's (kernels/fused_ce.py:
// fwd_plan): as many equal runs of tiles as keep the grid within two
// blocks an SM, so that it is one wave. Each block writes partial
// (m, l, tl) per row; a second kernel merges the splits in split order
// with the same rescale,
//   M = max m_s, L = sum l_s exp(m_s - M), TL = sum tl_s,
// and writes lse = M + log(max(L, 1e-30)) and tl. Two launches, counted by
// the wrapper as one launch of the kernel; no float atomics, so two runs
// on the same inputs give the same bits.
// - bf16 (linear_nll_fwd_tc_kernel, the main path's): 128 rows and
//   128-wide vocab tiles a block, two warpgroups; each tile's 128 x 128
//   logits h.W^T come from the backward's wgmma mainloop (tc_tile, below;
//   W "vd" K-major, "dv" MN-major, as they lie) into f32 registers, then an
//   epilogue adds the f32 bias, scores positions past V -1e30, captures the
//   target logit and updates (m, l, tl): a thread holds 32 values of each
//   of its two rows and the four lanes of a quad hold a row, so the row
//   max is two shuffles, and l, tl stay per thread until the end. Products
//   of bf16 values are exact in f32, so the logits differ from the plain
//   version's only by summation order. h's 128 x 768 tile is streamed from
//   L2 again for each vocab tile (192 KB a tile; at these shapes it stays
//   in L2). What limits it: as in the backward, tc_tile waits for each
//   stage's wgmma before the next barrier, and each tile's epilogue (64
//   exponentials a thread) runs between two mainloops, with no load in
//   flight.
// - f32 (linear_nll_partial_kernel, the first design, kept for the f32
//   checks, whose 2e-5 gates TF32 would break): f32 FMAs on the CUDA
//   cores, 64 rows and 64-wide vocab tiles a block; each tile's 64x64
//   logits a register-tiled product over D in chunks of 32, h and W chunks
//   staged in shared memory (both transposed to [d][row]). Thread (ty, tx)
//   owns rows ty+16i and vocab columns tx+16j (i, j < 4); the 16 threads of
//   a row are a half-warp, so the row max is a half-warp shuffle, while l
//   and tl stay per thread until the end.
//
// Backward. With g = (softmax - onehot) * ct, recomputed from the
// forward's lse as p = exp(s - lse): dh = g.W (g.W^T for "dv"),
// dW = g^T.h (h^T.g for "dv"), db = sum over rows of g. The reference
// recomputes the logits in both of its kernels; here they are computed once
// per vocab chunk and g is kept for that chunk only: the vocabulary is
// walked in chunks of C columns, each chunk's N x C slab of g in device
// memory (never the (N, V) logits), capped so that it stays in the 50 MB
// L2 for the two products that read it. The work split is the wrapper's
// (kernels/fused_ce.py: bwd_plan), passed in as a table and launched as
// given: the chunks, each launch's grid, and each dh split's columns. Per
// chunk, in order:
//   1. the logits tile and g, with db's column partials;
//   2. dh += g . W_chunk, split along the chunk (K) into n_split fixed
//      partial dh buffers so that the N x D output fills the SMs, each
//      partial accumulated over the chunks in order;
//   3. the chunk's rows of dW = g^T . h, written in W's dtype and layout
//      (each vocab column belongs to one chunk).
// Last, the dh partials are summed in a fixed order into dh in h's dtype
// (and, bf16, db's column partials over the row blocks). No float
// atomics: two runs on the same inputs give the same bits. The wrapper
// counts the whole sequence as one launch.
//
// f32 backward (CUDA cores, the first design, kept for the f32 gradient
// checks; TF32 would break their 2e-5 gates): 64x64 output tiles, each a
// register-tiled product (4x4 per thread) over operands staged as f32 in
// shared memory in chunks of 32, g in an f32 slab, db a column sum of the
// slab (linear_nll_bwd_colsum_kernel).
//
// bf16 backward (tensor cores, the main path's): every product is a
// wgmma.mma_async m64n128k16 with bf16 operands in shared memory and f32
// accumulators in registers, in one mainloop (tc_tile) that the three
// phases share with three epilogues. A block is two warpgroups, a 128x128
// output tile; the depth is walked in stages of 64, a ring of kTcStages
// stages in shared memory filled by cp.async (the next stages load while
// the tensor cores work on this one). The operands enter as they lie in
// device memory, K-major or MN-major, in the 128-byte-swizzled lines of
// tensor_core.cuh: g^T, W in "vd" and W in "dv" need no transposing copy.
// A 16-byte chunk that is not 16-byte aligned in device memory (W's rows in
// "dv" at V = 30522 or 50257, h's at D = 1100) or runs past the ragged edge
// is loaded element by element into the same place. g is rounded once to
// bf16 as it enters the products (the slab is bf16: half the bytes of
// f32); db's column partials are summed from the f32 g in phase 1's
// epilogue, per 128-row block, and merged over the row blocks in order.
//
// Masking follows the reference: vocab positions >= V (the ragged tail,
// 30522 = 476*64 + 58 = 238*128 + 58) score -1e30 in the forward and add
// nothing to l, since every split starts at a real vocab position, and
// get p = 0 (so g = 0) in the backward; the target logit is the score at
// vpos == target, 0 when no position matches. Rows past N (the ragged row
// block) get g = 0: the reference's padded rows with cotangent 0.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// its launches (cudaErrorInvalidValue for a dtype it was not built for)
// and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBN = 64;       // rows per block
constexpr int kBV = 64;       // vocab positions per tile
constexpr int kBD = 32;       // depth of one staged chunk
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <bool kDV>
__global__ void __launch_bounds__(kThreads)
linear_nll_partial_kernel(const float* __restrict__ h,
                          const float* __restrict__ w,
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

template <bool kDV>
int launch(const void* h, const void* w, const void* bias,
           const void* targets, void* part, void* lse, void* tl,
           int64_t n_rows, int64_t depth, int64_t vocab,
           int64_t tiles_per_split, int64_t n_split, cudaStream_t stream) {
  float* pm = static_cast<float*>(part);
  float* pl = pm + n_split * n_rows;
  float* pt = pl + n_split * n_rows;
  const dim3 grid(static_cast<unsigned>((n_rows + kBN - 1) / kBN),
                  static_cast<unsigned>(n_split));
  linear_nll_partial_kernel<kDV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
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
template <bool kDV>
__global__ void __launch_bounds__(kThreads)
linear_nll_bwd_g_kernel(const float* __restrict__ h,
                        const float* __restrict__ w,
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
// in split z's range [bounds[z], bounds[z + 1]) (bounds null: [0, K)); the
// 64x64 tile (blockIdx.x, blockIdx.y) of split z = blockIdx.z goes to
// out + z*o_split, at out[i*o_i + j]. accumulate = 0 stores, 1 adds to
// what out holds. Each output element has one owner.
__global__ void __launch_bounds__(kThreads)
linear_nll_bwd_gemm_kernel(const float* __restrict__ A, int64_t a_i,
                           int64_t a_k, const float* __restrict__ B,
                           int64_t b_k, int64_t b_j, float* __restrict__ out,
                           int64_t o_i, int64_t o_split, int M, int n_cols,
                           int K, const int* __restrict__ bounds,
                           int accumulate) {
  __shared__ float As[kBD * (kTile + 1)];
  __shared__ float Bs[kBD * (kTile + 1)];
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int k_begin = bounds ? bounds[blockIdx.z] : 0;
  const int k_end = bounds ? bounds[blockIdx.z + 1] : K;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  gemm_tile(A, a_i, a_k, M, B, b_k, b_j, n_cols, k_begin, k_end, i0, j0, As,
            Bs, acc);
  float* o = out + blockIdx.z * o_split;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= n_cols) continue;
      float* at = o + row * o_i + col;
      *at = accumulate ? *at + acc[i][j] : acc[i][j];
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

// One chunk's launches, as the wrapper's plan gives them (a row of
// kPlanCols int64): its columns [c0, c0 + cw) and the grids of its g, dh
// and dW kernels.
constexpr int kPlanCols = 9;
struct ChunkLaunch {
  int c0, cw;
  dim3 g, dh, dw;
};
inline ChunkLaunch chunk_launch(const int64_t* row) {
  const auto u = [](int64_t x) { return static_cast<unsigned>(x); };
  return {static_cast<int>(row[0]), static_cast<int>(row[1]),
          dim3(u(row[2]), u(row[3])), dim3(u(row[4]), u(row[5]), u(row[6])),
          dim3(u(row[7]), u(row[8]))};
}

template <bool kDV>
int launch_bwd(const void* h, const void* w, const void* bias,
               const void* targets, const void* lse, const void* ct,
               void* g, void* dh_part, void* dh, void* dw, void* db,
               int64_t n_rows, int64_t depth, int64_t vocab, int64_t chunk,
               int64_t n_split, const int64_t* plan, int64_t n_chunks,
               const int* bounds, cudaStream_t stream) {
  const float* ht = static_cast<const float*>(h);
  const float* wt = static_cast<const float*>(w);
  float* dwt = static_cast<float*>(dw);
  float* gs = static_cast<float*>(g);
  float* part = static_cast<float*>(dh_part);
  const int n = static_cast<int>(n_rows), d = static_cast<int>(depth);
  const int v = static_cast<int>(vocab), ch = static_cast<int>(chunk);
  for (int64_t i = 0; i < n_chunks; ++i) {
    const ChunkLaunch c = chunk_launch(plan + i * kPlanCols);
    const int c0 = c.c0, cw = c.cw;
    linear_nll_bwd_g_kernel<kDV><<<c.g, kThreads, 0, stream>>>(
        ht, wt, static_cast<const float*>(bias),
        static_cast<const int*>(targets), static_cast<const float*>(lse),
        static_cast<const float*>(ct), gs, n, d, v, c0, cw, ch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    linear_nll_bwd_colsum_kernel<<<(cw + 255) / 256, 256, 0, stream>>>(
        gs, static_cast<float*>(db), n, c0, cw, ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dh (n, d) += g (n, c) . W_chunk (c, d), split z over its bounds
    const int* kb = bounds + i * (n_split + 1);
    if (kDV)   // W_chunk (c, d) = W[d][c0 + c]
      linear_nll_bwd_gemm_kernel<<<c.dh, kThreads, 0, stream>>>(
          gs, ch, 1, wt + c0, 1, vocab, part, depth, n_rows * depth, n, d, cw,
          kb, i > 0);
    else       // W_chunk (c, d) = W[c0 + c][d]
      linear_nll_bwd_gemm_kernel<<<c.dh, kThreads, 0, stream>>>(
          gs, ch, 1, wt + c0 * depth, depth, 1, part, depth, n_rows * depth,
          n, d, cw, kb, i > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kDV)   // dW[d][c0 + c] = sum_n h[n][d] g[n][c]: rows d, columns c
      linear_nll_bwd_gemm_kernel<<<c.dw, kThreads, 0, stream>>>(
          ht, 1, depth, gs, ch, 1, dwt + c0, vocab, 0, d, cw, n, nullptr, 0);
    else       // dW[c0 + c][d] = sum_n g[n][c] h[n][d]: rows c, columns d
      linear_nll_bwd_gemm_kernel<<<c.dw, kThreads, 0, stream>>>(
          gs, 1, ch, ht, depth, 1, dwt + c0 * depth, depth, 0, cw, d, n,
          nullptr, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_elem = n_rows * depth;
  linear_nll_bwd_dh_sum_kernel<float>
      <<<static_cast<unsigned>((n_elem + 255) / 256), 256, 0, stream>>>(
          part, static_cast<float*>(dh), n_elem, static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcM = 128;          // output tile rows: two warpgroups of 64
constexpr int kTcN = 128;          // output tile columns
constexpr int kTcK = 64;           // depth of one stage: one 128-byte line
constexpr int kTcStages = 3;       // the cp.async ring
constexpr int kTcThreads = 256;
constexpr int kTcOperandBytes = 128 * 128;            // 128 lines of 128 B
constexpr int kTcStageBytes = 2 * kTcOperandBytes;    // A and B
// the dynamic shared memory a block needs: the ring, and 1 KB to align it;
// two blocks share an SM (228 KB, 1 KB of it reserved a block)
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + 1024;
static_assert(2 * (kTcSmemBytes + 1024) <= 228 * 1024,
              "two bf16 blocks an SM");

typedef __nv_bfloat16 bf16;

// The cp.async feed of one operand of tc_tile. Element (mn, k) of the
// operand is p[k*ld + mn] when kMn (MN-major), else p[mn*ld + k]; positions
// with mn >= mn_end or k >= k_end read as 0. A stage is the 128 x 64 tile
// at (mn0, k0) in the swizzled lines of tensor_core.cuh: thread t copies
// the 16-byte chunk t % 8 of lines t/8 + 32i (i < 4), so eight neighbouring
// threads cover one line, neighbouring addresses in device memory. What a
// thread's chunks are (their address, their shared offset, how many of
// their bytes lie inside the operand, whether they are 16-byte aligned) is
// worked out once per tile; a stage then only advances the address. A
// chunk that is not 16-byte aligned in device memory (a row of W in "dv" at
// an odd vocabulary, of h at D = 1100) is copied value by value.
template <bool kMn>
struct TcFeed {
  const bf16* src;   // chunk 0's first value at the current stage
  int64_t ld32;      // 32 lines on in device memory
  int k;             // chunk 0's depth at the current stage
  int bytes[4];      // chunk i's bytes inside the extent across the depth
  int dst;           // chunk 0's byte offset in a stage
  bool aligned;

  __device__ __forceinline__ void init(const bf16* p, int64_t ld, int mn0,
                                       int mn_end, int k_begin) {
    const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
    dst = r * 128 + ((c ^ (r & 7)) << 4);
    ld32 = 32 * ld;
    if (kMn) {   // line r + 32i: depth r + 32(i%2), mn block i/2
      k = k_begin + r;
      src = p + static_cast<int64_t>(k) * ld + mn0 + c * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bytes[i] = max(min((mn_end - (mn0 + (i >> 1) * 64 + c * 8)) * 2, 16),
                       0);
    } else {     // line r + 32i: row mn0 + r + 32i
      k = k_begin + c * 8;
      src = p + static_cast<int64_t>(mn0 + r) * ld + k;
#pragma unroll
      for (int i = 0; i < 4; ++i) bytes[i] = mn0 + r + 32 * i < mn_end ? 16 : 0;
    }
    aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  }

  // Issue this stage's copies into the operand stage at `stage` (p: any
  // valid address, the source of zero fills), then advance by 64 in depth.
  __device__ __forceinline__ void load(char* stage, const bf16* p,
                                       int k_end) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16* from = src + (kMn ? (i & 1) * ld32 + (i >> 1) * 64
                                    : i * ld32);
      const int n = kMn ? (k + 32 * (i & 1) < k_end ? bytes[i] : 0)
                        : min(bytes[i], max((k_end - k) * 2, 0));
      char* to = stage + dst + i * 4096;
      if (aligned || n == 0) {
        tc::cp_async16(to, n ? from : p, n);
      } else {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = 2 * j < n ? from[j] : __float2bfloat16(0.0f);
        tc::st_shared16(to, *reinterpret_cast<const uint4*>(v));
      }
    }
    src += kMn ? 2 * ld32 : kTcK;
    k += kTcK;
  }
};

// acc = this warpgroup's 64 x 128 share of the block's 128 x 128 tile
// (rows m0.., columns n0..) of sum over k in [k_begin, k_end) of
// A(m, k) * B(n, k); A of extent a_mn along m, B of b_mn along n (see
// TcFeed for the operands). acc is overwritten. Ends with every cp.async
// drained and a barrier, so the caller may reuse smem.
template <bool kAMn, bool kBMn>
__device__ __forceinline__ void tc_tile(char* smem, const bf16* a, int64_t lda,
                                        int a_mn, const bf16* b, int64_t ldb,
                                        int b_mn, int m0, int n0, int k_begin,
                                        int k_end, float (&acc)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  const int n_k = (k_end - k_begin + kTcK - 1) / kTcK;
  const int wg = threadIdx.x >> 7;
  TcFeed<kAMn> fa;
  TcFeed<kBMn> fb;
  fa.init(a, lda, m0, a_mn, k_begin);
  fb.init(b, ldb, n0, b_mn, k_begin);
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_k) {
      char* st = smem + s * kTcStageBytes;
      fa.load(st, a, k_end);
      fb.load(st + kTcOperandBytes, b, k_end);
    }
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<kTcStages - 2>();   // stage kt has landed
    tc::fence_proxy_async();
    __syncthreads();   // ... for every thread; and stage kt-1 is consumed
    if (kt + kTcStages - 1 < n_k) {
      char* st = smem + ((kt + kTcStages - 1) % kTcStages) * kTcStageBytes;
      fa.load(st, a, k_end);
      fb.load(st + kTcOperandBytes, b, k_end);
    }
    tc::cp_async_commit();
    const char* sa = smem + (kt % kTcStages) * kTcStageBytes + wg * 8192;
    const char* sb = smem + (kt % kTcStages) * kTcStageBytes +
                     kTcOperandBytes;
    tc::fence_operands(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint64_t da = kAMn ? tc::wgmma_desc(sa + kk * 2048, 8192, 1024)
                               : tc::wgmma_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = kBMn ? tc::wgmma_desc(sb + kk * 2048, 8192, 1024)
                               : tc::wgmma_desc(sb + kk * 32, 16, 1024);
      tc::wgmma_m64n128k16<kAMn ? 1 : 0, kBMn ? 1 : 0>(acc, da, db);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_operands(acc);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// The 1024-byte aligned start of the dynamic shared memory.
__device__ __forceinline__ char* tc_smem(char* raw) {
  return raw + ((1024 - (tc::smem_addr(raw) & 1023)) & 1023);
}

// Row of acc[j] within the block's tile, and its column (tensor_core.cuh).
__device__ __forceinline__ int tc_row(int j) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int tc_col(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

// Phase 1: for the chunk's vocab positions c0 + c, c < cw, the logits tile
// (rows m0.., chunk columns n0..) of h.W^T + b, then g into the bf16 slab
// (row stride `chunk`) and the tile's column sums of the f32 g into
// db_part[blockIdx.x][c0 + c]. W comes in at w_chunk, its chunk's first
// position: element (c, d) at w_chunk[c*ldw + d] ("vd") or
// w_chunk[d*ldw + c] ("dv").
template <bool kDV>
__global__ void __launch_bounds__(kTcThreads, 2)
linear_nll_bwd_g_tc_kernel(const bf16* __restrict__ h,
                           const bf16* __restrict__ w_chunk, int64_t ldw,
                           const float* __restrict__ bias,
                           const int* __restrict__ targets,
                           const float* __restrict__ lse,
                           const float* __restrict__ ct, bf16* __restrict__ g,
                           float* __restrict__ db_part, int n_rows, int depth,
                           int vocab, int c0, int cw, int chunk) {
  extern __shared__ char smem_raw[];
  char* smem = tc_smem(smem_raw);
  const int m0 = blockIdx.x * kTcM, n0 = blockIdx.y * kTcN;
  float acc[64];
  tc_tile<false, kDV>(smem, h, depth, n_rows, w_chunk, ldw, cw, m0, n0, 0,
                      depth, acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int tgt[2];
  float lse_r[2], ct_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + tc_row(2 * i);
    const bool in = row < n_rows;
    tgt[i] = in ? targets[row] : -1;
    lse_r[i] = in ? lse[row] : 0.0f;
    ct_r[i] = in ? ct[row] : 0.0f;
  }
  float* red = reinterpret_cast<float*>(smem);   // [8 warps][128 columns]
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    float colsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // rows r and r + 8, columns c and c + 1
      const int j = nb * 4 + 2 * i;
      const int row = m0 + tc_row(j);
      const int c = n0 + tc_col(j);
      float gv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row < n_rows && c + e < cw) {
          const int vp = c0 + c + e;
          gv[e] = prob_grad(acc[j + e] + bias[vp], vp, tgt[i], lse_r[i],
                            ct_r[i]);
        }
      if (row < n_rows && c < cw) {   // the slab's rows are even: aligned
        bf16* at = g + static_cast<int64_t>(row) * chunk + c;
        *reinterpret_cast<uint32_t*>(at) = tc::pack_bf16(gv[0], gv[1]);
      }
      colsum[0] = colsum[0] + gv[0];
      colsum[1] = colsum[1] + gv[1];
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      colsum[0] = colsum[0] + __shfl_xor_sync(0xffffffffu, colsum[0], off);
      colsum[1] = colsum[1] + __shfl_xor_sync(0xffffffffu, colsum[1], off);
    }
    if (lane < 4) {
      red[warp * kTcN + nb * 8 + 2 * lane] = colsum[0];
      red[warp * kTcN + nb * 8 + 2 * lane + 1] = colsum[1];
    }
  }
  __syncthreads();
  if (threadIdx.x < kTcN) {
    const int c = n0 + threadIdx.x;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kTcThreads / 32; ++w)
      sum = sum + red[w * kTcN + threadIdx.x];
    if (c < cw)
      db_part[static_cast<int64_t>(blockIdx.x) * vocab + c0 + c] = sum;
  }
}

// Phase 2: split z = blockIdx.z adds the chunk's columns [bounds[z],
// bounds[z + 1]) of g . W_chunk to part + z * n_rows * depth (stores them
// on the first chunk). W_chunk(c, d) = w_chunk[c*ldw + d] ("vd", an
// MN-major operand) or w_chunk[d*ldw + c] ("dv", K-major).
template <bool kDV>
__global__ void __launch_bounds__(kTcThreads, 2)
linear_nll_bwd_dh_tc_kernel(const bf16* __restrict__ g, int chunk,
                            const bf16* __restrict__ w_chunk, int64_t ldw,
                            float* __restrict__ part, int n_rows, int depth,
                            const int* __restrict__ bounds, int accumulate) {
  extern __shared__ char smem_raw[];
  char* smem = tc_smem(smem_raw);
  const int m0 = blockIdx.x * kTcM, n0 = blockIdx.y * kTcN;
  const int k_begin = bounds[blockIdx.z], k_end = bounds[blockIdx.z + 1];
  float acc[64];
  tc_tile<false, !kDV>(smem, g, chunk, n_rows, w_chunk, ldw, depth, m0, n0,
                       k_begin, k_end, acc);
  float* out = part + static_cast<int64_t>(blockIdx.z) * n_rows * depth;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {   // columns col and col + 1
    const int row = m0 + tc_row(j), col = n0 + tc_col(j);
    if (row >= n_rows || col >= depth) continue;
    float* at = out + static_cast<int64_t>(row) * depth + col;
    if (col + 1 < depth && (reinterpret_cast<uintptr_t>(at) & 7) == 0) {
      float2 v = accumulate ? *reinterpret_cast<float2*>(at)
                            : make_float2(0.0f, 0.0f);
      v.x = accumulate ? v.x + acc[j] : acc[j];
      v.y = accumulate ? v.y + acc[j + 1] : acc[j + 1];
      *reinterpret_cast<float2*>(at) = v;
    } else {
      at[0] = accumulate ? at[0] + acc[j] : acc[j];
      if (col + 1 < depth)
        at[1] = accumulate ? at[1] + acc[j + 1] : acc[j + 1];
    }
  }
}

// Phase 3: out(m, n) = sum over the n_rows rows r of A(m, r) * B(n, r),
// both MN-major (A(m, r) = a[r*lda + m]), written in bf16 at
// out[m*ld_out + n] for m < a_mn, n < b_mn: the chunk's rows of dW
// ("vd": A = g, B = h) or its columns ("dv": A = h, B = g).
__global__ void __launch_bounds__(kTcThreads, 2)
linear_nll_bwd_dw_tc_kernel(const bf16* __restrict__ a, int64_t lda, int a_mn,
                            const bf16* __restrict__ b, int64_t ldb, int b_mn,
                            int n_rows, bf16* __restrict__ out,
                            int64_t ld_out) {
  extern __shared__ char smem_raw[];
  char* smem = tc_smem(smem_raw);
  const int m0 = blockIdx.x * kTcM, n0 = blockIdx.y * kTcN;
  float acc[64];
  tc_tile<true, true>(smem, a, lda, a_mn, b, ldb, b_mn, m0, n0, 0, n_rows,
                      acc);
#pragma unroll
  for (int j = 0; j < 64; j += 2) {   // columns col and col + 1
    const int row = m0 + tc_row(j), col = n0 + tc_col(j);
    if (row >= a_mn || col >= b_mn) continue;
    bf16* at = out + static_cast<int64_t>(row) * ld_out + col;
    if (col + 1 < b_mn && (reinterpret_cast<uintptr_t>(at) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(at) = tc::pack_bf16(acc[j], acc[j + 1]);
    } else {
      at[0] = __float2bfloat16(acc[j]);
      if (col + 1 < b_mn) at[1] = __float2bfloat16(acc[j + 1]);
    }
  }
}

// db[v] = the sum over the row blocks, in order, of db_part[rb][v].
__global__ void linear_nll_bwd_db_kernel(const float* __restrict__ db_part,
                                         float* __restrict__ db,
                                         int row_blocks, int vocab) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vocab) return;
  float sum = 0.0f;
  for (int rb = 0; rb < row_blocks; ++rb)
    sum = sum + db_part[static_cast<int64_t>(rb) * vocab + v];
  db[v] = sum;
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTcSmemBytes);
}

template <bool kDV>
int launch_bwd_tc(const void* h, const void* w, const void* bias,
                  const void* targets, const void* lse, const void* ct,
                  void* g, void* dh_part, void* db_part, void* dh, void* dw,
                  void* db, int64_t n_rows, int64_t depth, int64_t vocab,
                  int64_t chunk, int64_t n_split, const int64_t* plan,
                  int64_t n_chunks, const int* bounds, cudaStream_t stream) {
  if (chunk % 8 != 0)   // the slab's rows 16-byte aligned for cp.async
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(linear_nll_bwd_g_tc_kernel<kDV>);
  if (err == cudaSuccess) err = allow_smem(linear_nll_bwd_dh_tc_kernel<kDV>);
  if (err == cudaSuccess) err = allow_smem(linear_nll_bwd_dw_tc_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* ht = static_cast<const bf16*>(h);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* gs = static_cast<bf16*>(g);
  bf16* dwt = static_cast<bf16*>(dw);
  float* part = static_cast<float*>(dh_part);
  float* dbp = static_cast<float*>(db_part);
  const int n = static_cast<int>(n_rows), d = static_cast<int>(depth);
  const int v = static_cast<int>(vocab), ch = static_cast<int>(chunk);
  constexpr int sm = kTcSmemBytes;
  for (int64_t i = 0; i < n_chunks; ++i) {
    const ChunkLaunch c = chunk_launch(plan + i * kPlanCols);
    const int c0 = c.c0, cw = c.cw;
    // W's chunk: element (c, d) at wc[c*ldw + d] ("vd") or wc[d*ldw + c]
    const bf16* wc = kDV ? wt + c0 : wt + static_cast<int64_t>(c0) * depth;
    const int64_t ldw = kDV ? vocab : depth;
    linear_nll_bwd_g_tc_kernel<kDV><<<c.g, kTcThreads, sm, stream>>>(
        ht, wc, ldw, static_cast<const float*>(bias),
        static_cast<const int*>(targets), static_cast<const float*>(lse),
        static_cast<const float*>(ct), gs, dbp, n, d, v, c0, cw, ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    linear_nll_bwd_dh_tc_kernel<kDV><<<c.dh, kTcThreads, sm, stream>>>(
        gs, ch, wc, ldw, part, n, d, bounds + i * (n_split + 1), i > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kDV)   // dW[d][c0 + c] = sum_r h[r][d] g[r][c]
      linear_nll_bwd_dw_tc_kernel<<<c.dw, kTcThreads, sm, stream>>>(
          ht, depth, d, gs, ch, cw, n, dwt + c0, vocab);
    else       // dW[c0 + c][d] = sum_r g[r][c] h[r][d]
      linear_nll_bwd_dw_tc_kernel<<<c.dw, kTcThreads, sm, stream>>>(
          gs, ch, cw, ht, depth, d, n,
          dwt + static_cast<int64_t>(c0) * depth, depth);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // db's column partials: one row per row block of the g grid
  const int row_blocks = static_cast<int>(plan[2]);
  linear_nll_bwd_db_kernel<<<static_cast<unsigned>((v + 255) / 256), 256, 0,
                             stream>>>(dbp, static_cast<float*>(db),
                                       row_blocks, v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_elem = n_rows * depth;
  linear_nll_bwd_dh_sum_kernel<bf16>
      <<<static_cast<unsigned>((n_elem + 255) / 256), 256, 0, stream>>>(
          part, static_cast<bf16*>(dh), n_elem, static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

// Split blockIdx.y's partial (m, l, tl) per row over its run of 128-wide
// vocab tiles, for the 128 rows m0..: per tile, the logits tile h.W^T + b
// from tc_tile (W element (v, d) at w[v*depth + d] in "vd", a K-major
// operand, or w[d*vocab + v] in "dv", MN-major), then the online update.
// A row's values lie in the four lanes of a quad, so the row max is two
// shuffles; l and tl are this thread's shares until the end.
template <bool kDV>
__global__ void __launch_bounds__(kTcThreads, 2)
linear_nll_fwd_tc_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         const int* __restrict__ targets,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_tl, int n_rows, int depth,
                         int vocab, int tiles_per_split) {
  extern __shared__ char smem_raw[];
  char* smem = tc_smem(smem_raw);
  const int m0 = blockIdx.x * kTcM;
  const int split = blockIdx.y;
  const int n_tiles = (vocab + kTcN - 1) / kTcN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int64_t ldw = kDV ? vocab : depth;

  int tgt[2];
  float m[2], l[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // rows tc_row(0) and tc_row(2), 8 apart
    const int row = m0 + tc_row(2 * i);
    tgt[i] = row < n_rows ? targets[row] : -1;
    m[i] = kNegInf;
    l[i] = 0.0f;
    tl[i] = 0.0f;
  }
  float acc[64];
  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * kTcN;
    tc_tile<false, kDV>(smem, h, depth, n_rows, w, ldw, vocab, m0, v0, 0,
                        depth, acc);
    // acc[j]: row tc_row(j) (i = (j >> 1) & 1), column tc_col(j)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int vp = v0 + tc_col(nb * 4 + c);
        const float b = vp < vocab ? bias[vp] : 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = nb * 4 + 2 * i + c;
          float x = kNegInf;   // past the vocabulary: adds 0 to l
          if (vp < vocab) {
            x = acc[j] + b;
            if (vp == tgt[i]) tl[i] = tl[i] + x;
          }
          acc[j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      l[i] = l[i] * expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int i = (j >> 1) & 1;
      l[i] = l[i] + expf(acc[j] - m[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i], ti = tl[i];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      li = li + __shfl_xor_sync(0xffffffffu, li, off);
      ti = ti + __shfl_xor_sync(0xffffffffu, ti, off);
    }
    const int row = m0 + tc_row(2 * i);
    if ((threadIdx.x & 3) == 0 && row < n_rows) {
      const int64_t at = static_cast<int64_t>(split) * n_rows + row;
      part_m[at] = m[i];
      part_l[at] = li;
      part_tl[at] = ti;
    }
  }
}

template <bool kDV>
int launch_fwd_tc(const void* h, const void* w, const void* bias,
                  const void* targets, void* part, void* lse, void* tl,
                  int64_t n_rows, int64_t depth, int64_t vocab,
                  int64_t tiles_per_split, int64_t n_split,
                  cudaStream_t stream) {
  const cudaError_t attr = allow_smem(linear_nll_fwd_tc_kernel<kDV>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float* pm = static_cast<float*>(part);
  float* pl = pm + n_split * n_rows;
  float* pt = pl + n_split * n_rows;
  const dim3 grid(static_cast<unsigned>((n_rows + kTcM - 1) / kTcM),
                  static_cast<unsigned>(n_split));
  linear_nll_fwd_tc_kernel<kDV><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
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

}  // namespace


// dtype: 0 = float32, 1 = bfloat16; w_dv: 0 = W (V, D), 1 = W (D, V).
// part: 3 * n_split * n_rows floats of scratch. The work split is the
// caller's (kernels/fused_ce.py fwd_plan), launched as given: vocab tiles
// of `tile` positions and row blocks of `row_block` rows (f32: 64 and 64,
// bf16: 128 and 128, the kernels' own; anything else is refused), the
// splits partitioning the ceil(vocab / tile) tiles into runs of
// tiles_per_split, none empty.
extern "C" int hetu_fused_linear_nll_fwd(
    const void* h, const void* w, const void* bias, const void* targets,
    void* part, void* lse, void* tl, int64_t n_rows, int64_t depth,
    int64_t vocab, int64_t tile, int64_t row_block, int64_t tiles_per_split,
    int64_t n_split, int w_dv, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tile == kBV && row_block == kBN)
    return w_dv ? launch<true>(h, w, bias, targets, part, lse, tl, n_rows,
                               depth, vocab, tiles_per_split, n_split, s)
                : launch<false>(h, w, bias, targets, part, lse, tl, n_rows,
                                depth, vocab, tiles_per_split, n_split, s);
  if (dtype == 1 && tile == kTcN && row_block == kTcM)
    return w_dv ? launch_fwd_tc<true>(h, w, bias, targets, part, lse, tl,
                                      n_rows, depth, vocab, tiles_per_split,
                                      n_split, s)
                : launch_fwd_tc<false>(h, w, bias, targets, part, lse, tl,
                                       n_rows, depth, vocab, tiles_per_split,
                                       n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16; w_dv: 0 = W (V, D), 1 = W (D, V).
// lse and ct are (n_rows,) f32; dh and dw are written in the input dtype,
// db (vocab,) in f32. The work split is the caller's (kernels/fused_ce.py
// bwd_plan), launched as given: plan, a host table of n_chunks rows of
// kPlanCols int64 (c0, cw, the grids of the g, dh and dW kernels); bounds,
// device memory, n_split + 1 ints a chunk, the dh splits' column bounds
// within the chunk. Scratch: g, the N x chunk slab in the input dtype
// (chunk, its row stride); dh_part, n_split * N * D floats, each stored by
// the first chunk; db_part (bf16 only), one row of V floats per row block
// of the g grid.
extern "C" int hetu_fused_linear_nll_bwd(
    const void* h, const void* w, const void* bias, const void* targets,
    const void* lse, const void* ct, void* g, void* dh_part, void* db_part,
    void* dh, void* dw, void* db, int64_t n_rows, int64_t depth,
    int64_t vocab, int64_t chunk, int64_t n_split, const int64_t* plan,
    int64_t n_chunks, const int* bounds, int w_dv, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && w_dv)
    return launch_bwd<true>(h, w, bias, targets, lse, ct, g, dh_part, dh, dw,
                            db, n_rows, depth, vocab, chunk, n_split, plan,
                            n_chunks, bounds, s);
  if (dtype == 0)
    return launch_bwd<false>(h, w, bias, targets, lse, ct, g, dh_part, dh,
                             dw, db, n_rows, depth, vocab, chunk, n_split,
                             plan, n_chunks, bounds, s);
  if (dtype == 1 && w_dv)
    return launch_bwd_tc<true>(h, w, bias, targets, lse, ct, g, dh_part,
                               db_part, dh, dw, db, n_rows, depth, vocab,
                               chunk, n_split, plan, n_chunks, bounds, s);
  if (dtype == 1)
    return launch_bwd_tc<false>(h, w, bias, targets, lse, ct, g, dh_part,
                                db_part, dh, dw, db, n_rows, depth, vocab,
                                chunk, n_split, plan, n_chunks, bounds, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
