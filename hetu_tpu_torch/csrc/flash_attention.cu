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
// (f32, as the reference computes it in XLA; bf16: computed by the dq
// kernel from the dO and O tiles it loads, f32: by a kernel before it),
// each tile recomputes its probabilities p = exp(s - lse) from q and k
// instead of reading an (S, S) tensor, then
//   dp = dO.V^T, ds = p * (dp - delta) * scale,
//   dq = ds.K, dk = ds^T.Q, dv = p^T.dO.
//
// Bounds on an H100 SXM at the BERT-base shape (B=32, H=12, S=128, D=64,
// bf16). Forward: 4*B*H*S*S*D = 1.6 GFLOP against reading q, k, v and
// writing o once, 25 MB: 1.6 us at 989 TFLOP/s and 7.5 us at 3.35 TB/s, so
// the bound is the memory (at S = 512: 25.8 GFLOP, 26 us, against 100 MB,
// 30 us). Backward: 10*B*H*S*S*D = 4.0 GFLOP (4.1 us) against reading q,
// k, v, o, dO and writing dq, dk, dv, 50 MB (15 us): memory again. The bf16
// kernels (the main path's) run their products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); the f32 ones compute every
// product with f32 FMAs on the CUDA cores (67 TFLOP/s peak), bound by their
// own arithmetic, kept for the f32 checks, whose 2e-5 gates TF32 would
// break; their design point is to be right and to read each operand tile
// once per block from device memory.
//
// Forward design, bf16 (flash_fwd_tc_kernel, FlashAttention-2's shape). A
// block owns 128 query rows of one (b, h), 8 warps of 16 rows; it stages
// its q tile once (each warp keeps its q fragments in registers) and
// streams 64-key tiles of k, v and the key bias through a two-stage
// cp.async ring, so each tile read from L2 serves 128 rows. Per tile, each
// warp computes s = Q.K^T (K as the col-major operand as it lies), then
// x = s * scale + bias and the masks, the online (m, l) update in
// registers (a row's 64 values lie in the four lanes of a quad: the row max
// is two shuffles; l is each lane's share until the end), rescales acc by
// exp(m_old - m_new), and adds p.V with p rounded once to bf16 as the A
// fragments (to_a_frag, no trip through shared memory) and V read through
// ldmatrix.trans. l sums the f32 p, so lse = m + log(l) is the reference's
// up to summation order; o = acc / l, rounded once. The reference keeps p
// in f32: one bf16 rounding of p moves o by ~2e-3 of its relative L2 norm
// (the gate is 1e-2). The key tiles a block visits are the plan's
// (kernels/flash_attention.py tile_plan, fwd_key_tiles); a tile in which no
// key is masked for any row of the block skips the per-key tests. What
// bounds it now (BERT-base layer, one H100 SXM at 700 W): not its
// arithmetic; removing the products or the softmax of a tile barely moves
// its time. Streaming k and v cost most while blocks held 64 rows (S / 64
// reads of each from L2), and so did reading the bias from device memory
// in the loop; both are halved or gone. It now runs 16 warps an SM at a
// 128-register cap (head_dim 64 spills a few bytes); one block an SM,
// without the cap, is slower, and a deeper ring does not help. A
// wgmma/TMA, warp-specialized design is the next step.
//
// Forward design, f32 (flash_fwd_kernel, kept). Grid (B*H, ceil(S/64));
// 256 threads as a 16x16 grid (ty, tx). A block loads its 64 query rows
// (times scale, as _fwd_kernel does) into shared memory once, then
// streams the plan's 64-key tiles of k (stored transposed) and v through
// shared memory. Thread (ty, tx) owns score rows ty+16i and key columns
// tx+16j (i, j < 4), and output rows ty+16i, columns tx+16j (j < D/16); the
// 16 threads of one row are one half-warp, so the row max and row sum are
// half-warp shuffles.
//
// Backward design. Two kernels, launched back to back and counted by the
// wrapper as one launch; each grid block owns disjoint outputs, so there
// are no float atomics and the result is deterministic (the forward's
// blocks, too, own their rows). The grids and the tiles each
// block visits, in both directions, are the wrapper's
// (kernels/flash_attention.py: tile_plan), passed in and launched as
// given.
// - dq, grid (B*H, ceil(S/64)): a block owns 64 query rows and loops over
//   64-key tiles of k and v from the first to the plan's last, the tile of
//   the rows' last visited key. Per tile: s and dp, ds, then dq += ds.K.
// - dkv, grid (B*H, ceil(S/64)): a block owns 64 keys and loops over
//   64-row tiles of q and dO, from the plan's first, the first tile whose
//   rows visit these keys (the causal lower bound), to the last. Per tile:
//   s^T and dp^T, p and ds, then dv += p^T.dO and dk += ds^T.Q.
// f32 (flash_bwd_delta_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel;
// CUDA cores, kept for the f32 gradient checks, whose 2e-5 gates TF32
// would break): delta first, a warp a row, then 256 threads a block,
// s and dp as 4x4 register tiles per thread over f32 tiles in shared
// memory (k, v, q, dO stored transposed), ds (and p) through shared
// memory. At head_dim 128 the dq kernel stages 149 KB and the dkv kernel
// 166 KB, above the 48 KB default; the launch raises the block's limit
// with cudaFuncSetAttribute (the H100 allows 227 KB).
// bf16 (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel): 4 warps, each
// owning 16 of the block's 64 rows (keys); the tiles stay bf16 in shared
// memory (rows padded by 16 bytes, so that ldmatrix reads eight rows from
// eight different banks), 63 and 55 KB at head_dim 64, 119 and 103 KB at
// 128, the next key (query) tile loaded by cp.async while this one is
// used. The dq kernel first computes delta for its rows from the dO and O
// tiles (tc_delta) and writes it for the dkv kernel: no PyTorch pass and
// no kernel before them. Every product is an mma.sync.m16n8k16 fed by
// ldmatrix: s = Q.K^T and dp = dO.V^T with K and V as the col-major
// operand as they lie, then ds . K, p^T . dO and ds^T . Q with
// ldmatrix.trans. The dkv kernel computes the
// transposed tiles s^T = K.Q^T and dp^T = V.dO^T directly, so p^T and
// ds^T come out in the accumulator layout of rows = keys, which is the
// A-operand layout of the next product: p and ds go from registers to the
// next product, with no trip through shared memory, f32 until then. p
// enters rounded once to bf16; ds enters as two bf16 terms, hi = bf16(ds)
// and lo = bf16(ds - hi), two products. A fully masked row has p = 1 at
// every visited key, so its ds is S times its usual size and its products
// cancel: one bf16 rounding of ds there moved dq and dk past the 2e-2
// gates. Everywhere else one rounding holds, but two cut dq's and dk's
// relative L2 error against the plain version from 2.6e-3 to 1.0e-4 at
// no cost at S = 128 and 9 % more time at S = 512 (BERT-base layer, one
// H100 SXM at 700 W).
//
// Masking follows the reference exactly, in both directions:
// - k_bias is added to every score column;
// - causal scores above the diagonal are -1e30, not -inf: a fully padded
//   row then degenerates to a uniform softmax, as in the reference, where
//   -inf would give exp(-inf - (-inf)) = NaN;
// - the reference skips, per q block of block_q rows, every key block of
//   block_k keys above the diagonal (ceil bound of _causal_upper_kb); its
//   dkv kernel starts at the matching q block, so both directions visit
//   the same (q block, k block) pairs. The kernels' own tiles differ
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

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kbias,
                 const int* __restrict__ tiles, float* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, float scale,
                 int causal, int req_bq, int req_bk) {
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
  const float* qp = q + base;
  const float* kp = k + base;
  const float* vp = v + base;
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
  // the key tiles the plan gives this block's query tile
  const int kv_end = tiles[blockIdx.y] * kBK;

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

  float* op = o + base;
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kbias,
           void* o, void* lse, int64_t heads, int64_t seq, float scale,
           int causal, int64_t block_q, int64_t block_k, dim3 grid,
           const int* tiles, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block needs the opt-in, which holds for the device that
  // is current; setting it at every launch keeps any device right
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kbias), tiles,
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<int>(seq),
      static_cast<int>(heads), scale, causal, static_cast<int>(block_q),
      static_cast<int>(block_k));
  return static_cast<int>(cudaGetLastError());
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ kbias,
                    const int* __restrict__ tiles, float* __restrict__ dq,
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
  const float* kp = k + base;
  const float* vp = v + base;
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
  // the key tiles the plan gives this block's query tile
  const int kv_end = tiles[blockIdx.y] * kBK;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kbias,
                     const int* __restrict__ tiles, float* __restrict__ dk,
                     float* __restrict__ dv, int seq, int heads, float scale,
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
  const float* qp = q + base;
  const float* dop = dout + base;
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
  // the first query tile the plan gives this block's keys (causal: the
  // rows before it visit none of them)
  const int q_begin = tiles[gridDim.y + blockIdx.y] * kBQ;

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

// delta[r] = sum over d of dO[r][d] * O[r][d] for the f32 kernels, one warp
// a row: lane l sums d = l, l + 32, ... in order, then the lanes add in a
// fixed butterfly.
__global__ void flash_bwd_delta_kernel(const float* __restrict__ o,
                                       const float* __restrict__ dout,
                                       float* __restrict__ delta,
                                       int64_t rows, int head_dim) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;   // a whole warp returns
  float sum = 0.0f;
  for (int d = lane; d < head_dim; d += 32)
    sum = sum + dout[r * head_dim + d] * o[r * head_dim + d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[r] = sum;
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta,
               const void* kbias, void* dq, void* dk, void* dv,
               int64_t heads, int64_t seq, float scale, int causal,
               int64_t block_q, int64_t block_k, dim3 grid, const int* tiles,
               cudaStream_t stream) {
  constexpr size_t smem_dq = bwd_dq_smem_bytes<D>();
  constexpr size_t smem_dkv = bwd_dkv_smem_bytes<D>();
  static_assert(smem_dq <= 227 * 1024 && smem_dkv <= 227 * 1024,
                "a block's shared memory on the H100");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const float* bf = static_cast<const float*>(kbias);
  const int s = static_cast<int>(seq), h = static_cast<int>(heads);
  const int bq = static_cast<int>(block_q), bk = static_cast<int>(block_k);
  const int64_t rows = static_cast<int64_t>(grid.x) * seq;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           stream>>>(static_cast<const float*>(o), dot, df,
                                     rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, lf, df, bf, tiles, static_cast<float*>(dq), s, h,
      scale, causal, bq, bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lf, df, bf, tiles, static_cast<float*>(dk),
      static_cast<float*>(dv), s, h, scale, causal, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;   // 4 warps x 16 rows (keys)

// Shared memory of the bf16 kernels: bf16 tiles of 64 rows padded to D + 8
// values. dq: q, dO, O and two stages of k and v, and 64 delta; dkv: k, v
// and two stages of q and dO, and two stages of 64 lse and 64 delta.
template <int D>
constexpr size_t bwd_dq_tc_smem_bytes() {
  return 7 * 64 * (D + 8) * sizeof(bf16) + 64 * sizeof(float);
}
template <int D>
constexpr size_t bwd_dkv_tc_smem_bytes() {
  return 6 * 64 * (D + 8) * sizeof(bf16) + 4 * 64 * sizeof(float);
}

// Rows row0 .. row0+63 of a (seq, D) bf16 matrix into a shared tile of row
// stride D + 8, by cp.async, by the block's kN threads; rows >= seq are
// zero.
template <int D, int kN = kTcThreads>
__device__ __forceinline__ void tc_load_rows(bf16* dst,
                                             const bf16* __restrict__ src,
                                             int row0, int seq) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < 64 * kChunks; e += kN) {
    const int r = e / kChunks, c = e % kChunks;
    const int row = row0 + r;
    const bool in = row < seq;
    tc::cp_async16(dst + r * (D + 8) + c * 8,
                   in ? src + static_cast<int64_t>(row) * D + c * 8 : src,
                   in ? 16 : 0);
  }
}

// ldmatrix addresses within a shared tile of row stride D + 8, for this
// lane, of a 16 x 16 block at (r0, c0): as the A operand (rows r0.., the
// depth c0..) and as two n8 B operands read from a [n][k] tile (rows =
// n) or, transposed, from a [k][n] tile (rows = k).
template <int D>
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8) + c0 +
         (lane >> 4) * 8;
}
template <int D>
__device__ __forceinline__ const bf16* frag_b_nk(const bf16* t, int n0,
                                                 int k0) {
  const int lane = threadIdx.x & 31;
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * (D + 8) + k0 +
         ((lane >> 3) & 1) * 8;
}
template <int D>
__device__ __forceinline__ const bf16* frag_b_kn(const bf16* t, int k0,
                                                 int n0) {
  const int lane = threadIdx.x & 31;
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8) + n0 +
         (lane >> 4) * 8;
}

// acc[8][4] (16 rows x 64 columns) = X_rows . Y^T over depth D: X from a
// [row][d] tile at row r0, Y a [col][d] tile of 64 rows. Two products at
// once, sharing Y's fragments' addresses: (x1, y1) -> acc1, (x2, y2) ->
// acc2.
template <int D>
__device__ __forceinline__ void tc_scores(const bf16* x1, const bf16* y1,
                                          const bf16* x2, const bf16* y2,
                                          int r0, float (&acc1)[8][4],
                                          float (&acc2)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[i][e] = acc2[i][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a1[4], a2[4];
    tc::ldsm_x4(a1, frag_a<D>(x1, r0, kk * 16));
    tc::ldsm_x4(a2, frag_a<D>(x2, r0, kk * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b1[4], b2[4];
      tc::ldsm_x4(b1, frag_b_nk<D>(y1, np * 16, kk * 16));
      tc::ldsm_x4(b2, frag_b_nk<D>(y2, np * 16, kk * 16));
      tc::mma_bf16(acc1[2 * np], a1, b1[0], b1[1]);
      tc::mma_bf16(acc1[2 * np + 1], a1, b1[2], b1[3]);
      tc::mma_bf16(acc2[2 * np], a2, b2[0], b2[1]);
      tc::mma_bf16(acc2[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc[D/8][4] (16 rows x D) += A (16 x 64, bf16 fragments a[k step][4]) .
// Y (64 x D) from a [k][d] tile; with kTwo, A is the sum of two bf16
// terms, a and a2, each a product of its own.
template <int D, bool kTwo>
__device__ __forceinline__ void tc_accumulate(const uint32_t (&a)[4][4],
                                              const uint32_t (&a2)[4][4],
                                              const bf16* y,
                                              float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      tc::ldsm_x4_trans(b, frag_b_kn<D>(y, kc * 16, dn * 16));
      tc::mma_bf16(acc[2 * dn], a[kc], b[0], b[1]);
      tc::mma_bf16(acc[2 * dn + 1], a[kc], b[2], b[3]);
      if (kTwo) {
        tc::mma_bf16(acc[2 * dn], a2[kc], b[0], b[1]);
        tc::mma_bf16(acc[2 * dn + 1], a2[kc], b[2], b[3]);
      }
    }
}

// The accumulator tile (16 x 64, n-tile nt, element e: row g + 8*(e/2),
// column 8*nt + 2*(lane%4) + e%2) as the A operand of the next product:
// n-tiles 2kc and 2kc+1 are k step kc.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4][4], int nt,
                                          const float (&x)[4]) {
  a[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(x[0], x[1]);
  a[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(x[2], x[3]);
}

// x as two bf16 terms: hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void to_a_frag2(uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], int nt,
                                           const float (&x)[4]) {
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r[e] = x[e] - __bfloat162float(__float2bfloat16(x[e]));
  to_a_frag(hi, nt, x);
  to_a_frag(lo, nt, r);
}

// delta_s[r] = sum over d of dO[r][d] * O[r][d] in f32 for the 64 rows of
// a tile pair in shared memory: two threads a row, each summing half of the
// row in order, then the two halves.
template <int D>
__device__ __forceinline__ void tc_delta(const bf16* dOt, const bf16* Ot,
                                         float* delta_s) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const bf16* a = dOt + r * (D + 8) + half * (D / 2);
  const bf16* b = Ot + r * (D + 8) + half * (D / 2);
  float sum = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D / 2; ++d)
    sum = sum + __bfloat162float(a[d]) * __bfloat162float(b[d]);
  sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
  if (!half) delta_s[r] = sum;
}

template <int D>
__device__ __forceinline__ void tc_store_rows(bf16* __restrict__ out,
                                              const float (&acc)[D / 8][4],
                                              const int (&row)[2], int seq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= seq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row[i]) * D +
                                   dn * 8 + 2 * (lane & 3)) =
          tc::pack_bf16(acc[dn][2 * i], acc[dn][2 * i + 1]);
  }
}

// One key tile of the dq kernel: s = Q.K^T and dp = dO.V^T for this
// warp's 16 rows, ds, then acc += ds.K with ds as two bf16 terms.
template <int D>
__device__ __forceinline__ void dq_tile(
    const bf16* Qs, const bf16* dOs, const bf16* Kt, const bf16* Vt, int k0,
    const int (&row)[2], const int (&lim)[2], const float (&lse_r)[2],
    const float (&delta_r)[2], const float* bp, float scale, int causal,
    float (&acc)[D / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[8][4], dp[8][4];
  tc_scores<D>(Qs, Kt, dOs, Vt, warp * 16, s, dp);
  uint32_t ads[4][4], ads_lo[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
      ds[e] = 0.0f;   // a key the reference never visits for this row
      if (key < lim[i]) {
        float x = s[nt][e] * scale;
        if (bp) x = x + bp[key];
        if (causal && key > row[i]) x = kNegInf;
        const float p = expf(x - lse_r[i]);
        ds[e] = p * (dp[nt][e] - delta_r[i]) * scale;
      }
    }
    to_a_frag2(ads, ads_lo, nt, ds);
  }
  tc_accumulate<D, true>(ads, ads_lo, Kt, acc);
}

// One query tile of the dkv kernel (rows r0..): s^T = K.Q^T and
// dp^T = V.dO^T for this warp's 16 keys, p and ds, then dv += p^T.dO and
// dk += ds^T.Q with ds as two bf16 terms.
template <int D>
__device__ __forceinline__ void dkv_tile(
    const bf16* Ks, const bf16* Vs, const bf16* Qt, const bf16* dOt,
    const float* lt, const float* dt, int r0, const int (&key)[2],
    const float (&kb)[2], const float* bp, int seq, float scale, int causal,
    int req_bq, int req_bk, float (&acc_dk)[D / 8][4],
    float (&acc_dv)[D / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // transposed tiles: rows are this warp's 16 keys, columns query rows
  float st[8][4], dpt[8][4];
  tc_scores<D>(Ks, Qt, Vs, dOt, warp * 16, st, dpt);
  uint32_t ap[4][4], ads[4][4], ads_lo[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
      const int qrow = r0 + c;
      p[e] = ds[e] = 0.0f;
      // key_limit <= seq, so this also drops keys and rows past the end
      if (qrow < seq &&
          key[i] < key_limit(qrow, seq, causal, req_bq, req_bk)) {
        float x = st[nt][e] * scale;
        if (bp) x = x + kb[i];
        if (causal && key[i] > qrow) x = kNegInf;
        p[e] = expf(x - lt[c]);
        ds[e] = p[e] * (dpt[nt][e] - dt[c]) * scale;
      }
    }
    to_a_frag(ap, nt, p);
    to_a_frag2(ads, ads_lo, nt, ds);
  }
  tc_accumulate<D, false>(ap, ap, dOt, acc_dv);
  tc_accumulate<D, true>(ads, ads_lo, Qt, acc_dk);
}

// Blocks of a bf16 kernel an SM holds at once: at head_dim <= 64 the
// register budget is capped so that three fit (the shared memory allows
// three), at 128 a block takes what it needs.
template <int D>
constexpr int tc_min_blocks() {
  return D <= 64 ? 3 : 1;
}

// dq: a block owns 64 query rows (blockIdx.y) and visits their key tiles.
// It first computes delta for its rows from the dO and O tiles and writes
// it for the dkv kernel, which runs after it.
template <int D>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<D>())
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta,
                       const float* __restrict__ kbias,
                       const int* __restrict__ tiles, bf16* __restrict__ dq,
                       int seq, int heads, float scale, int causal,
                       int req_bq, int req_bk) {
  constexpr int kT = 64 * (D + 8);   // one tile, in values
  extern __shared__ __align__(16) char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kT;
  bf16* Os = dOs + kT;
  bf16* Ks = Os + kT;           // [2 stages][64][D + 8]
  bf16* Vs = Ks + 2 * kT;       // [2 stages][64][D + 8]
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * kT);   // [64]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int q0 = blockIdx.y * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const int64_t rbase = static_cast<int64_t>(bh) * seq;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;

  tc_load_rows<D>(Qs, q + base, q0, seq);
  tc_load_rows<D>(dOs, dout + base, q0, seq);
  tc_load_rows<D>(Os, o + base, q0, seq);
  tc_load_rows<D>(Ks, k + base, 0, seq);
  tc_load_rows<D>(Vs, v + base, 0, seq);
  tc::cp_async_commit();

  int row[2], lim[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + (lane >> 2) + 8 * i;
    lim[i] = key_limit(row[i], seq, causal, req_bq, req_bk);
    lse_r[i] = row[i] < seq ? lse[rbase + row[i]] : 0.0f;
  }
  const int n_tiles = tiles[blockIdx.y];   // the plan's key tiles

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      tc_load_rows<D>(Ks + ((t + 1) & 1) * kT, k + base, (t + 1) * 64, seq);
      tc_load_rows<D>(Vs + ((t + 1) & 1) * kT, v + base, (t + 1) * 64, seq);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {   // q, dO and O have landed: the rows' delta
      tc_delta<D>(dOs, Os, delta_s);
      __syncthreads();
      if (threadIdx.x < 64 && q0 + threadIdx.x < seq)
        delta[rbase + q0 + threadIdx.x] = delta_s[threadIdx.x];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        delta_r[i] = delta_s[warp * 16 + (lane >> 2) + 8 * i];
    }
    const bf16* Kt = Ks + (t & 1) * kT;
    const bf16* Vt = Vs + (t & 1) * kT;
    dq_tile<D>(Qs, dOs, Kt, Vt, t * 64, row, lim, lse_r, delta_r, bp, scale,
               causal, acc);
    __syncthreads();   // this stage is consumed before it is refilled
  }
  tc_store_rows<D>(dq + base, acc, row, seq);
}

// dkv: a block owns 64 keys (blockIdx.y) and visits the query tiles that
// visit them, with the dq kernel's delta.
template <int D>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<D>())
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kbias,
                        const int* __restrict__ tiles,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int seq, int heads, float scale, int causal,
                        int req_bq, int req_bk) {
  constexpr int kT = 64 * (D + 8);
  extern __shared__ __align__(16) char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kT;
  bf16* Qs = Vs + kT;           // [2 stages][64][D + 8]
  bf16* dOs = Qs + 2 * kT;      // [2 stages][64][D + 8]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kT);   // [2][64]
  float* delta_s = lse_s + 2 * 64;                         // [2][64]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int k0 = blockIdx.y * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const int64_t rbase = static_cast<int64_t>(bh) * seq;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;

  // from the first query tile the plan gives this block's keys to the last
  const int first = tiles[gridDim.y + blockIdx.y];
  const int q_begin = first * 64;
  const int n_tiles = gridDim.y - first;

  tc_load_rows<D>(Ks, k + base, k0, seq);
  tc_load_rows<D>(Vs, v + base, k0, seq);
  tc_load_rows<D>(Qs, q + base, q_begin, seq);
  tc_load_rows<D>(dOs, dout + base, q_begin, seq);
  tc::cp_async_commit();
  if (threadIdx.x < 64) {
    const int r = q_begin + threadIdx.x;
    lse_s[threadIdx.x] = r < seq ? lse[rbase + r] : 0.0f;
    delta_s[threadIdx.x] = r < seq ? delta[rbase + r] : 0.0f;
  }

  int key[2];
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + (lane >> 2) + 8 * i;
    kb[i] = (bp && key[i] < seq) ? bp[key[i]] : 0.0f;
  }
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = q_begin + t * 64;
    const int nb = (t + 1) & 1;
    if (t + 1 < n_tiles) {
      tc_load_rows<D>(Qs + nb * kT, q + base, r0 + 64, seq);
      tc_load_rows<D>(dOs + nb * kT, dout + base, r0 + 64, seq);
      if (threadIdx.x < 64) {
        const int r = r0 + 64 + threadIdx.x;
        lse_s[nb * 64 + threadIdx.x] = r < seq ? lse[rbase + r] : 0.0f;
        delta_s[nb * 64 + threadIdx.x] = r < seq ? delta[rbase + r] : 0.0f;
      }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + (t & 1) * kT;
    const bf16* dOt = dOs + (t & 1) * kT;
    const float* lt = lse_s + (t & 1) * 64;
    const float* dt = delta_s + (t & 1) * 64;
    dkv_tile<D>(Ks, Vs, Qt, dOt, lt, dt, r0, key, kb, bp, seq, scale, causal,
                req_bq, req_bk, acc_dk, acc_dv);
    __syncthreads();   // this stage is consumed before it is refilled
  }
  tc_store_rows<D>(dk + base, acc_dk, key, seq);
  tc_store_rows<D>(dv + base, acc_dv, key, seq);
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta,
                  const void* kbias, void* dq, void* dk, void* dv,
                  int64_t heads, int64_t seq, float scale, int causal,
                  int64_t block_q, int64_t block_k, dim3 grid,
                  const int* tiles, cudaStream_t stream) {
  constexpr size_t smem_dq = bwd_dq_tc_smem_bytes<D>();
  constexpr size_t smem_dkv = bwd_dkv_tc_smem_bytes<D>();
  // as many blocks an SM as the register cap allows (228 KB, 1 KB of it
  // reserved a block)
  static_assert(tc_min_blocks<D>() * (smem_dq + 1024) <= 228 * 1024 &&
                    tc_min_blocks<D>() * (smem_dkv + 1024) <= 228 * 1024,
                "the bf16 blocks an SM holds");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const float* bf = static_cast<const float*>(kbias);
  const int s = static_cast<int>(seq), h = static_cast<int>(heads);
  const int bq = static_cast<int>(block_q), bk = static_cast<int>(block_k);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), dot, lf, df, bf, tiles,
      static_cast<bf16*>(dq), s, h, scale, causal, bq, bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lf, df, bf, tiles, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, h, scale, causal, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

// The bf16 forward's block: 128 query rows, a warp for each 16 of them,
// so that each 64-key tile of k and v streamed into shared memory serves
// 128 rows (K and V are read from L2 S / 128 times, not S / 64).
constexpr int kFwdRows = 128;
constexpr int kFwdThreads = 2 * kFwdRows;
constexpr int kFwdStages = 2;   // the k, v (and bias) ring: a tile ahead

// Blocks of the bf16 forward an SM holds at once: two at head_dim <= 64,
// which caps a thread at 128 registers (the shared memory allows more),
// one at 128.
template <int D>
constexpr int tc_fwd_min_blocks() {
  return D <= 64 ? 2 : 1;
}

// Shared memory of the bf16 forward: the q tile (128 rows), kFwdStages
// stages each of k and v (64 rows), bf16 rows padded to D + 8 values, and
// kFwdStages stages of the 64 keys' bias, f32.
template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return (kFwdRows + 2 * kFwdStages * 64) * (D + 8) * sizeof(bf16) +
         kFwdStages * 64 * sizeof(float);
}

// One key tile's k and v rows k0.. and, with a bias, its 64 values, into
// a stage, by cp.async.
template <int D>
__device__ __forceinline__ void fwd_load_tile(bf16* Kt, bf16* Vt, float* Bt,
                                              const bf16* k, const bf16* v,
                                              const float* bp, int k0,
                                              int seq) {
  tc_load_rows<D, kFwdThreads>(Kt, k, k0, seq);
  tc_load_rows<D, kFwdThreads>(Vt, v, k0, seq);
  if (bp && threadIdx.x < 64) {
    const int key = k0 + threadIdx.x;
    tc::cp_async4(Bt + threadIdx.x, key < seq ? bp + key : bp,
                  key < seq ? 4 : 0);
  }
}

// s[8][4] (16 rows x 64 keys) = Q.K^T over depth D for this warp's rows:
// Q as A fragments already in registers (qa[k step]), K a [key][d] tile.
template <int D>
__device__ __forceinline__ void tc_scores_q(const uint32_t (&qa)[D / 16][4],
                                            const bf16* kt, float (&s)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      tc::ldsm_x4(b, frag_b_nk<D>(kt, np * 16, kk * 16));
      tc::mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
      tc::mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
}

// One key tile of the forward for this warp's 16 rows: s = Q.K^T, then
// x = s * scale + bias (bt: the tile's bias in shared memory, or null) and
// the masks of dq_tile; the online update of the row max m and of this
// thread's share l of the row sum (the four lanes of a quad hold a row, so
// the max is two shuffles); acc rescaled; acc += p.V with p rounded once to
// bf16 as the A operand, straight from the registers, and V read through
// ldmatrix.trans. `full`: no key of the tile is masked for any row of the
// block (block-uniform), so the per-key tests are skipped. p = exp(x - m)
// is exp2f((x - m) * log2(e)): x - m is taken first, in natural units, so
// a fully padded row's x = m = -1e30 gives p = 1 exactly.
template <int D>
__device__ __forceinline__ void fwd_tile(
    const uint32_t (&qa)[D / 16][4], const bf16* Kt, const bf16* Vt,
    const float* bt, int k0, bool full, const int (&row)[2],
    const int (&lim)[2], float scale, int causal, float (&m)[2],
    float (&l)[2], float (&acc)[D / 8][4]) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x & 31;
  float s[8][4];
  tc_scores_q<D>(qa, Kt, s);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c0 = nt * 8 + 2 * (lane & 3);   // the tile's column of e = 0
    if (full) {
      const float b0 = bt ? bt[c0] : 0.0f;
      const float b1 = bt ? bt[c0 + 1] : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fmaf(s[nt][e], scale, (e & 1) ? b1 : b0);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + c0 + (e & 1);
        float x = -INFINITY;   // a key the reference never visits for this row
        if (key < lim[i]) {
          x = fmaf(s[nt][e], scale, bt ? bt[c0 + (e & 1)] : 0.0f);
          if (causal && key > row[i]) x = kNegInf;
        }
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);   // finite: m starts at -1e30
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);
    l[i] = l[i] * alpha[i];
    m[i] = m_new;
  }
  uint32_t pa[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2f((s[nt][e] - m[e >> 1]) * kLog2e);
      l[e >> 1] = l[e >> 1] + p[e];   // l sums the f32 p
    }
    to_a_frag(pa, nt, p);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = acc[dn][e] * alpha[e >> 1];
  tc_accumulate<D, false>(pa, pa, Vt, acc);
}

// A block owns 128 query rows (blockIdx.y) of one (batch, head)
// (blockIdx.x), a warp 16 of them, and visits the plan's key tiles of its
// rows, the next one loaded by cp.async while this one is used.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, tc_fwd_min_blocks<D>())
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ kbias,
                    const int* __restrict__ tiles, bf16* __restrict__ o,
                    float* __restrict__ lse, int seq, int heads, float scale,
                    int causal, int req_bq, int req_bk) {
  constexpr int kT = 64 * (D + 8);   // one 64-row tile, in values
  extern __shared__ __align__(16) char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [128][D + 8]
  bf16* Ks = Qs + 2 * kT;                // [kFwdStages][64][D + 8]
  bf16* Vs = Ks + kFwdStages * kT;       // [kFwdStages][64][D + 8]
  float* Bs = reinterpret_cast<float*>(Vs + kFwdStages * kT);   // [.][64]

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int q0 = blockIdx.y * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(bh) * seq * D;
  const float* bp = kbias ? kbias + static_cast<int64_t>(batch) * seq : nullptr;
  const int n_tiles = tiles[blockIdx.y];   // the plan's key tiles

  tc_load_rows<D, kFwdThreads>(Qs, q + base, q0, seq);
  tc_load_rows<D, kFwdThreads>(Qs + kT, q + base, q0 + 64, seq);
  tc::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kFwdStages - 1; ++t) {   // a group each, even empty
    if (t < n_tiles)
      fwd_load_tile<D>(Ks + t * kT, Vs + t * kT, Bs + t * 64, k + base,
                       v + base, bp, t * 64, seq);
    tc::cp_async_commit();
  }

  int row[2], lim[2];
  float m[2], l[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + (lane >> 2) + 8 * i;
    lim[i] = key_limit(row[i], seq, causal, req_bq, req_bk);
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;
  // keys below lim0 are visited by every row of the block (the limit
  // rises with the row), and causal keys up to q0 are above no row's
  // diagonal
  const int lim0 = key_limit(q0, seq, causal, req_bq, req_bk);

  tc::cp_async_wait<kFwdStages - 1>();   // q has landed: its fragments
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    tc::ldsm_x4(qa[kk], frag_a<D>(Qs, warp * 16, kk * 16));

  for (int t = 0; t < n_tiles; ++t) {
    const int ahead = t + kFwdStages - 1;   // into the stage t - 1 freed
    if (ahead < n_tiles) {
      const int st = ahead % kFwdStages;
      fwd_load_tile<D>(Ks + st * kT, Vs + st * kT, Bs + st * 64, k + base,
                       v + base, bp, ahead * 64, seq);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<kFwdStages - 1>();   // tile t has landed
    __syncthreads();
    const int st = t % kFwdStages, k0 = t * 64;
    const bool full = k0 + 64 <= lim0 && (!causal || k0 + 63 <= q0);
    fwd_tile<D>(qa, Ks + st * kT, Vs + st * kT, bp ? Bs + st * 64 : nullptr,
                k0, full, row, lim, scale, causal, m, l, acc);
    __syncthreads();   // this stage is consumed before it is refilled
  }

  // o = acc / l and lse = m + log(l), l the quad's sum of its shares
  float* lp = lse + static_cast<int64_t>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li = li + __shfl_xor_sync(0xffffffffu, li, 1);
    li = li + __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][2 * i] = acc[dn][2 * i] / li;
      acc[dn][2 * i + 1] = acc[dn][2 * i + 1] / li;
    }
    if ((lane & 3) == 0 && row[i] < seq) lp[row[i]] = m[i] + logf(li);
  }
  tc_store_rows<D>(o + base, acc, row, seq);
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* kbias, void* o, void* lse, int64_t heads,
                  int64_t seq, float scale, int causal, int64_t block_q,
                  int64_t block_k, dim3 grid, const int* tiles,
                  cudaStream_t stream) {
  constexpr size_t smem = fwd_tc_smem_bytes<D>();
  // as many blocks an SM as tc_fwd_min_blocks asks (228 KB, 1 KB of it
  // reserved a block)
  static_assert(tc_fwd_min_blocks<D>() * (smem + 1024) <= 228 * 1024,
                "the bf16 forward blocks an SM holds");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_tc_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(kbias), tiles,
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<int>(seq),
      static_cast<int>(heads), scale, causal, static_cast<int>(block_q),
      static_cast<int>(block_k));
  return static_cast<int>(cudaGetLastError());
}

// The head_dim dispatch of the forward: f32 on the CUDA cores, bf16 on the
// tensor cores.
int launch_fwd_any(int64_t head_dim, int dtype, const void* q, const void* k,
                   const void* v, const void* kbias, void* o, void* lse,
                   int64_t heads, int64_t seq, float scale, int causal,
                   int64_t block_q, int64_t block_k, dim3 grid,
                   const int* tiles, cudaStream_t s) {
#define HETU_FWD_CASE(D)                                                     \
  case D:                                                                    \
    if (dtype == 0)                                                          \
      return launch<D>(q, k, v, kbias, o, lse, heads, seq, scale, causal,    \
                       block_q, block_k, grid, tiles, s);                    \
    if (dtype == 1)                                                          \
      return launch_fwd_tc<D>(q, k, v, kbias, o, lse, heads, seq, scale,     \
                              causal, block_q, block_k, grid, tiles, s);     \
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    HETU_FWD_CASE(16)
    HETU_FWD_CASE(32)
    HETU_FWD_CASE(64)
    HETU_FWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HETU_FWD_CASE
}

// The head_dim dispatch of the backward: f32 on the CUDA cores, bf16 on
// the tensor cores.
int launch_bwd_any(int64_t head_dim, int dtype, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, const void* kbias,
                   void* dq, void* dk, void* dv, int64_t heads, int64_t seq,
                   float scale, int causal, int64_t block_q, int64_t block_k,
                   dim3 grid, const int* tiles, cudaStream_t s) {
#define HETU_BWD_CASE(D)                                                     \
  case D:                                                                    \
    if (dtype == 0)                                                          \
      return launch_bwd<D>(q, k, v, o, dout, lse, delta, kbias, dq, dk, dv,  \
                           heads, seq, scale, causal, block_q, block_k,      \
                           grid, tiles, s);                                  \
    if (dtype == 1)                                                          \
      return launch_bwd_tc<D>(q, k, v, o, dout, lse, delta, kbias, dq, dk,   \
                              dv, heads, seq, scale, causal, block_q,        \
                              block_k, grid, tiles, s);                      \
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    HETU_BWD_CASE(16)
    HETU_BWD_CASE(32)
    HETU_BWD_CASE(64)
    HETU_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HETU_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kbias may be null (no bias). o is
// written in the input dtype, lse (B*H, S) in f32. The work split is the
// caller's (kernels/flash_attention.py tile_plan), launched as given: the
// grid (grid_x = B*H, grid_y = query blocks: of 64 rows in f32, of
// kFwdRows = 128 in bf16) and tiles, device memory, for each query block
// the count of key tiles it visits.
extern "C" int hetu_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kbias, void* o,
    void* lse, int64_t heads, int64_t seq, int64_t head_dim, float scale,
    int causal, int64_t block_q, int64_t block_k, int64_t grid_x,
    int64_t grid_y, const int* tiles, int dtype, void* stream) {
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  return launch_fwd_any(head_dim, dtype, q, k, v, kbias, o, lse, heads, seq,
                        scale, causal, block_q, block_k, grid, tiles,
                        static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16. kbias may be null (no bias). lse is
// (B*H, S) f32; delta = rowsum(dO * O), (B*H, S) f32, is written in the
// sequence (f32: by a kernel before the dq kernel; bf16: by the dq kernel)
// for the kernels after it. dq, dk and dv are written in the input dtype.
// The work split is the caller's (kernels/flash_attention.py tile_plan),
// launched as given: the grid (grid_x = B*H, grid_y = query tiles = key
// tiles) of both kernels, and tiles, device memory, grid_y + grid_y ints:
// for each query tile the count of key tiles its dq block visits, then for
// each key tile the first query tile its dkv block visits.
extern "C" int hetu_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, const void* kbias,
    void* dq, void* dk, void* dv, int64_t heads, int64_t seq,
    int64_t head_dim, float scale, int causal, int64_t block_q,
    int64_t block_k, int64_t grid_x, int64_t grid_y, const int* tiles,
    int dtype, void* stream) {
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  return launch_bwd_any(head_dim, dtype, q, k, v, o, dout, lse, delta, kbias,
                        dq, dk, dv, heads, seq, scale, causal, block_q,
                        block_k, grid, tiles,
                        static_cast<cudaStream_t>(stream));
}
