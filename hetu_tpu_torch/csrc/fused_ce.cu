// Fused linear + softmax cross-entropy forward for Hopper (sm_90a): per row
// n of h (N, D), the logsumexp over the vocabulary of s = h.W^T + b and the
// target's logit s[target], without the (N, V) logits in device memory.
//
// Port of the TPU kernel hetu_tpu/kernels/fused_ce.py:_fused_fwd (body
// _fwd_kernel). W comes in either layout: "vd" (V, D), the tied-embedding
// orientation, logits = h.W^T + b; "dv" (D, V), the LM-head orientation,
// logits = h.W + b. Neither is transposed or padded by a copy.
//
// Bound on an H100 SXM: 2*N*V*D flops against reading h, W, b and targets
// once and writing two floats per row. At the BERT-base MLM shape (N = 640,
// V = 30522, D = 768, bf16) that is 30 GFLOP and 47 MB: 30 us at
// 989 TFLOP/s and 14 us at 3.35 TB/s, so the bound is the operations. This
// first kernel computes h.W^T with f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not the tensor cores, so it is bound by its own arithmetic; the
// design point is to be right, to read W once per row block, and to keep
// the logits in registers. wgmma/TMA tiles are later work.
//
// Design. The vocabulary is split across blocks: at N = 640 a grid over 64-
// row blocks alone would be 10 blocks for 132 SMs. Grid (ceil(N/64),
// n_split); block (rb, sp) sweeps its contiguous run of 64-wide vocab tiles
// and keeps, per row, the online (m, l, tl) that _fwd_kernel keeps in VMEM
// scratch. Each tile's 64x64 logits are a register-tiled product over D in
// chunks of 32, h and W chunks staged in shared memory (both transposed to
// [d][row], bf16 converted to f32 on load). Thread (ty, tx) owns rows
// ty+16i and vocab columns tx+16j (i, j < 4); the 16 threads of a row are a
// half-warp, so the row max is a half-warp shuffle, while l and tl stay
// per thread until the end. Each block writes partial (m, l, tl) per row;
// a second kernel merges the splits with the same rescale,
//   M = max m_s, L = sum l_s exp(m_s - M), TL = sum tl_s,
// and writes lse = M + log(max(L, 1e-30)) and tl. Two launches, counted by
// the wrapper as one launch of the kernel.
//
// Masking follows the reference: vocab positions >= V (the ragged tail,
// 30522 = 476*64 + 58) score -1e30 and add nothing to l, since every split
// starts at a real vocab position; the target logit is the score at
// vpos == target, 0 when no position matches.
//
// C interface for ctypes: returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a dtype it was not built for) and launches on
// the given stream.

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
