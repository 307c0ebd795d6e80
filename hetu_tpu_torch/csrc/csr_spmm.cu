// CSR sparse x dense products for Hopper (sm_90a): csr_spmm and csr_spmv.
//
// Ports of the TPU kernels hetu_tpu/kernels/csr_spmm.py:_spmm_pallas (body
// _spmm_kernel) and :_spmv_pallas. Both compute, for a sparse A in CSR form
// (rowptr int32 [nrow + 1], col int32 [nnz], val float32 [nnz]),
//
//     Z[r, :] = sum over row r's entries j, in CSR order, of val[j] * B[col[j], :]
//
// with B a (K, F) float32 matrix (csr_spmm) or a (K,) vector (csr_spmv).
//
// Summation order. Each output element is ONE float32 accumulator, started
// at 0 and updated acc = acc + val[j] * b over the row's entries in CSR
// order, then written once. The build passes -fmad=false, so the product is
// rounded before the add, as the plain PyTorch version
// (hetu_tpu_torch/kernels/csr_spmm.py:_spmm_plain) rounds it: the two sum
// the same terms in the same order and agree bit for bit.
//
// Ownership. The TPU kernel walks the COO entries on a sequential grid and
// accumulates into a VMEM-resident output. Blocks here run in parallel and
// in no order, so each output row is owned by one warp (csr_spmm: the
// warp's 32 lanes stride over F, 8 columns a lane a pass, so F <= 256 is
// one pass) or by one thread (csr_spmv): no atomics, no cross-block
// reduction, and the result does not depend on scheduling. Each warp or
// thread issues the loads of 4 entries before their 4 adds, which run in
// CSR order: more loads in flight, the same sum. The TPU's VMEM-residency
// limit, its F % 128 rule and the (K, 128) lane padding of the vector have
// no counterpart.
//
// Bound. At GCN widths (nnz ~ 15 per row, F = 128-256) the work is bytes:
// read rowptr, col, val once, each B row about once per neighbour (the
// least is once, from L2), write Z once; 2 * nnz * F flops are negligible.
// This first version keeps each row's sum serial in one warp: a row of
// high degree runs long on one SM (faster designs: vectorized loads, a
// row split with an ordered merge, L2-aware ordering).
//
// Offsets r * F and col * F are 64-bit. C interface for ctypes: every
// function returns cudaGetLastError() after its launch (0 on success) and
// launches on the given stream; a call with nrow = 0 launches one block
// that writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rows per spmm block, one per warp
constexpr int kCols = 8;           // columns a lane holds per pass
constexpr int kPass = 32 * kCols;  // columns a warp covers per pass
constexpr int kUnroll = 4;         // entries whose loads are issued together
constexpr int kThreads = 256;      // spmv: rows per block, one per thread

// x[i] = br[c_i] for this lane's columns c_i = f0 + lane + 32 i (0 past f)
__device__ __forceinline__ void load_row(const float* __restrict__ br,
                                         int64_t f0, int64_t f,
                                         float (&x)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int64_t c = f0 + threadIdx.x + 32 * i;
    x[i] = c < f ? br[c] : 0.0f;
  }
}

__global__ void spmm_kernel(const int* __restrict__ rowptr,
                            const int* __restrict__ col,
                            const float* __restrict__ val,
                            const float* __restrict__ b,
                            float* __restrict__ z, int64_t nrow, int64_t f) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  if (r >= nrow) return;
  const int start = rowptr[r];
  const int end = rowptr[r + 1];
  float* zr = z + r * f;
  for (int64_t f0 = 0; f0 < f; f0 += kPass) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
    int j = start;
    // kUnroll entries at a time: all their loads first, then the adds in
    // CSR order, so the sum is the same as one entry at a time
    for (; j + kUnroll <= end; j += kUnroll) {
      float v[kUnroll];
      float x[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = val[j + u];
        load_row(b + static_cast<int64_t>(col[j + u]) * f, f0, f, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] = acc[i] + v[u] * x[u][i];
      }
    }
    for (; j < end; ++j) {
      float x[kCols];
      const float v = val[j];
      load_row(b + static_cast<int64_t>(col[j]) * f, f0, f, x);
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = acc[i] + v * x[i];
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t c = f0 + threadIdx.x + 32 * i;
      if (c < f) zr[c] = acc[i];
    }
  }
}

__global__ void spmv_kernel(const int* __restrict__ rowptr,
                            const int* __restrict__ col,
                            const float* __restrict__ val,
                            const float* __restrict__ x,
                            float* __restrict__ z, int64_t nrow) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= nrow) return;
  const int end = rowptr[r + 1];
  float acc = 0.0f;
  int j = rowptr[r];
  for (; j + kUnroll <= end; j += kUnroll) {   // loads first, adds in order
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = x[col[j + u]];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = acc + val[j + u] * p[u];
  }
  for (; j < end; ++j) acc = acc + val[j] * x[col[j]];
  z[r] = acc;
}

unsigned int blocks_for(int64_t n, int per_block) {
  const int64_t b = (n + per_block - 1) / per_block;
  return static_cast<unsigned int>(b > 0 ? b : 1);
}

}  // namespace

extern "C" int hetu_csr_spmm(const void* rowptr, const void* col,
                             const void* val, const void* b, void* z,
                             int64_t nrow, int64_t f, void* stream) {
  spmm_kernel<<<blocks_for(nrow, kWarps), dim3(32, kWarps), 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(b),
      static_cast<float*>(z), nrow, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetu_csr_spmv(const void* rowptr, const void* col,
                             const void* val, const void* x, void* z,
                             int64_t nrow, void* stream) {
  spmv_kernel<<<blocks_for(nrow, kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<float*>(z), nrow);
  return static_cast<int>(cudaGetLastError());
}
