// CSR sparse x dense products for Hopper (sm_90a): csr_spmm and csr_spmv.
//
// Ports of the TPU kernels hetu_tpu/kernels/csr_spmm.py:_spmm_pallas (body
// _spmm_kernel) and :_spmv_pallas. Both compute, for a sparse A in CSR form
// (col int32 [nnz], val float32 [nnz]; the row ranges come in the plan),
//
//     Z[r, :] = sum over row r's entries j of val[j] * B[col[j], :]
//
// with B a (K, F) float32 matrix (csr_spmm) or a (K,) vector (csr_spmv).
//
// Work split. The wrapper's plan (hetu_tpu_torch/kernels/csr_spmm.py:
// chunk_plan) cuts each row into chunks of at most kSpmmChunk (csr_spmm)
// or kSpmvChunk (csr_spmv) consecutive entries in CSR order; an empty row
// is one chunk of no entries. Per chunk it gives (row, start, end, slot):
// slot is -1 where the row is one chunk, else the chunk's row in a
// workspace of partials. Per split row (a row of more than one chunk) it
// gives (row, first slot, parts). The kernels read these as given and work
// out no range of their own; an entry point refuses (cudaErrorInvalidValue)
// a plan cut to another chunk size.
//
// Summation order. Per output element: each chunk sums into ONE float32
// accumulator started at 0, acc = acc + val[j] * b over its entries in CSR
// order. A row of one chunk is written directly, so its order, and its
// bits, are a serial sum over the row. A split row's partials are folded in
// chunk order, left to right: ((p0 + p1) + p2) + .... No atomic adds a
// value and nothing depends on scheduling, so a rerun is bit-equal. The
// build passes -fmad=false, so each product is rounded before the add, as
// the plain PyTorch version (kernels/csr_spmm.py:_spmm_plain) rounds it:
// the two agree bit for bit.
//
// What bounds it. The work is bytes: read the chunks, col and val once,
// a B row per entry (from L2 where the column is popular), write Z once;
// 2 * nnz * F flops are negligible. The first design gave each row to one
// warp or thread, so a row of high degree (4,315 entries in the GCN's
// arxiv-sized graph) was one chain of dependent loads that set the
// kernel's time. Chunks bound that chain at 32 entries a warp or thread,
// and the long row's partials are folded with many loads in flight.
//
// csr_spmm: one warp a chunk of at most 32 entries, one a lane, so its
// col and val arrive in one coalesced load each and reach the warp by
// shuffles: no dependent index load per round. A warp covers a slab of 128
// columns, 4 a lane: one float4 load when F % 4 == 0 and B, Z and the
// workspace are 16-byte aligned (the vector layout), else 4 scalar loads
// 32 columns apart (any F, in the same kernel code). The slabs are the
// grid's y, so a wider F runs more warps of few registers rather than
// fewer of more (8 columns a lane took 102 registers and was slower), and
// the blocks of one slab, which run together, share a narrower working
// set of B in L2. Loads of kUnroll entries are issued before their adds,
// which run in CSR order. A second launch, one warp a split row and slab,
// folds the partials from the workspace, kUnroll rows of loads in flight.
//
// csr_spmv: one thread a chunk (kThreads chunks a block), kUnroll gathers
// of x in flight. A thread's chunk lies about 15 entries from its
// neighbours', so a warp's loads of col and val touch a line a lane;
// staging the block's products in shared memory with coalesced loads
// measured no faster (the gathers of x through L2 set the time), so this
// simple layout stays. A second launch, one warp a split row, loads its
// partials kFold rounds of 32 at a time and folds them in order from
// shuffles. Measured slower on the H100, so not kept: one launch in which a
// warp sums a split row's chunks 32 at a time (the longest row's rounds
// run one after another), and a merge in the chunk kernel elected by an
// atomic counter (one thread folding the longest row became the tail).
//
// The TPU's VMEM-residency limit, its F % 128 rule and the (K, 128) lane
// padding of the vector have no counterpart.
//
// Offsets r * F, col * F and slot * F are 64-bit. C interface for ctypes:
// every function returns cudaGetLastError() after its launches (0 on
// success) and launches on the given stream; a call with no chunk (nrow =
// 0) launches one block that writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpmmChunk = 32;     // entries a csr_spmm chunk holds at most
constexpr int kSpmvChunk = 32;     // entries a csr_spmv chunk holds at most
constexpr int kWarps = 8;          // chunks (spmm) or split rows per block
constexpr int kCols = 4;           // columns a lane holds in a slab
constexpr int kSlab = 32 * kCols;  // columns of B one warp covers
constexpr int kMaxSlabs = 65535;   // gridDim.y; more slabs loop
constexpr int kUnroll = 8;         // rows whose loads are issued together
constexpr int kThreads = 256;      // spmv: chunks per block, one a thread
constexpr int kFold = 4;           // spmv merge: rounds of 32 partials loaded
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSpmmChunk == 32, "csr_spmm gives a chunk's entries one a lane");
static_assert(kCols == 4, "the vector layout is one float4 a lane");

// x[i] = br[c_i] for this lane's kCols columns c_i of the slab at f0 (0
// past f). Vector layout: c = f0 + 4 lane + i (f % 4 == 0, so c < f covers
// all four, one float4); scalar layout: c = f0 + lane + 32 i.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ br,
                                         int64_t f0, int64_t f,
                                         float (&x)[kCols]) {
  if constexpr (kVec) {
    const int64_t c = f0 + 4 * threadIdx.x;
    const float4 q = c < f ? *reinterpret_cast<const float4*>(br + c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t c = f0 + threadIdx.x + 32 * i;
      x[i] = c < f ? br[c] : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ out, int64_t f0,
                                          int64_t f,
                                          const float (&acc)[kCols]) {
  if constexpr (kVec) {
    const int64_t c = f0 + 4 * threadIdx.x;
    if (c < f)
      *reinterpret_cast<float4*>(out + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t c = f0 + threadIdx.x + 32 * i;
      if (c < f) out[c] = acc[i];
    }
  }
}

// One warp a chunk and a slab of kSlab columns (blockIdx.y): its sum over
// B's rows, into Z (slot -1) or the workspace. chunks is int32 [4,
// nchunk]: row, start, end, slot.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
spmm_chunk_kernel(const int* __restrict__ chunks, int64_t nchunk,
                  const int* __restrict__ col, const float* __restrict__ val,
                  const float* __restrict__ b, float* __restrict__ z,
                  float* __restrict__ ws, int64_t f) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  if (c >= nchunk) return;           // the whole warp: c is the warp's
  const int row = chunks[c];
  const int start = chunks[nchunk + c];
  const int n = chunks[2 * nchunk + c] - start;     // <= kSpmmChunk
  const int slot = chunks[3 * nchunk + c];
  const int lane = threadIdx.x;
  const int my_col = lane < n ? col[start + lane] : 0;
  const float my_val = lane < n ? val[start + lane] : 0.0f;
  float* out = slot < 0 ? z + static_cast<int64_t>(row) * f
                        : ws + static_cast<int64_t>(slot) * f;
  for (int64_t f0 = blockIdx.y * int64_t{kSlab}; f0 < f;
       f0 += gridDim.y * int64_t{kSlab}) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
    // kUnroll entries a round: all their loads first, then the adds in CSR
    // order, so the sum is the same as one entry at a time. The last round
    // is predicated (k + u < n is the same on every lane), so a chunk of n
    // entries takes ceil(n / kUnroll) rounds of dependent loads.
    for (int k = 0; k < n; k += kUnroll) {
      float v[kUnroll];
      float x[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cj = __shfl_sync(kFull, my_col, k + u);
        v[u] = __shfl_sync(kFull, my_val, k + u);
        if (k + u < n)
          load_row<kVec>(b + static_cast<int64_t>(cj) * f, f0, f,
                                x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < n) {
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[i] = acc[i] + v[u] * x[u][i];
        }
      }
    }
    store_row<kVec>(out, f0, f, acc);
  }
}

// One warp a split row: Z[row] = ((p0 + p1) + p2) + ... over its partials
// ws[first], ..., ws[first + parts - 1]. splits is int32 [3, nsplit]: row,
// first slot, parts (>= 2). One warp a split row and a slab.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
spmm_merge_kernel(const int* __restrict__ splits, int64_t nsplit,
                  const float* __restrict__ ws, float* __restrict__ z,
                  int64_t f) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  if (s >= nsplit) return;
  const int row = splits[s];
  const float* p = ws + static_cast<int64_t>(splits[nsplit + s]) * f;
  const int parts = splits[2 * nsplit + s];
  for (int64_t f0 = blockIdx.y * int64_t{kSlab}; f0 < f;
       f0 += gridDim.y * int64_t{kSlab}) {
    float acc[kCols];
    load_row<kVec>(p, f0, f, acc);           // p0
    for (int k = 1; k < parts; k += kUnroll) {      // the last round predicated
      float x[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + u < parts)
          load_row<kVec>(p + static_cast<int64_t>(k + u) * f, f0, f,
                                x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < parts) {
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[i] = acc[i] + x[u][i];
        }
      }
    }
    store_row<kVec>(z + static_cast<int64_t>(row) * f, f0, f, acc);
  }
}

// One thread a chunk: its sum over x, into z (slot -1) or the workspace;
// kUnroll entries a round, loads first, the last round predicated.
__global__ void __launch_bounds__(kThreads)
spmv_chunk_kernel(const int* __restrict__ chunks, int64_t nchunk,
                  const int* __restrict__ col, const float* __restrict__ val,
                  const float* __restrict__ x, float* __restrict__ z,
                  float* __restrict__ ws) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= nchunk) return;
  const int start = chunks[nchunk + c];
  const int n = chunks[2 * nchunk + c] - start;
  const int slot = chunks[3 * nchunk + c];
  float acc = 0.0f;
  for (int k = 0; k < n; k += kUnroll) {
    float v[kUnroll], p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u < n) {
        v[u] = val[start + k + u];
        p[u] = x[col[start + k + u]];
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u < n) acc = acc + v[u] * p[u];
  }
  if (slot < 0)
    z[chunks[c]] = acc;
  else
    ws[slot] = acc;
}

// One warp a split row of csr_spmv: the lanes load 32 partials at a time,
// and every lane folds them in order from shuffles, ((p0 + p1) + p2)
// + ...; lane 0 writes.
__global__ void __launch_bounds__(32 * kWarps)
spmv_merge_kernel(const int* __restrict__ splits, int64_t nsplit,
                  const float* __restrict__ ws, float* __restrict__ z) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  if (s >= nsplit) return;
  const float* p = ws + splits[nsplit + s];
  const int parts = splits[2 * nsplit + s];
  const int lane = threadIdx.x;
  float acc = 0.0f;
  for (int k0 = 0; k0 < parts; k0 += 32 * kFold) {
    float mine[kFold];                  // kFold rounds of loads in flight
#pragma unroll
    for (int r = 0; r < kFold; ++r) {
      const int k = k0 + 32 * r + lane;
      mine[r] = k < parts ? p[k] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kFold; ++r) {
      if (k0 + 32 * r >= parts) break;  // the same on every lane
#pragma unroll
      for (int u = 0; u < 32; ++u) {    // the shuffles issue back to back
        const float q = __shfl_sync(kFull, mine[r], u);
        const int k = k0 + 32 * r + u;
        if (k < parts) acc = k == 0 ? q : acc + q;
      }
    }
  }
  if (lane == 0) z[splits[s]] = acc;
}

unsigned int blocks_for(int64_t n, int per_block) {
  const int64_t b = (n + per_block - 1) / per_block;
  return static_cast<unsigned int>(b > 0 ? b : 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec>
void launch_spmm(const int* chunks, int64_t nchunk, const int* splits,
                 int64_t nsplit, const int* col, const float* val,
                 const float* b, float* z, float* ws, int64_t f,
                 cudaStream_t stream) {
  const unsigned slabs = blocks_for(f, kSlab) < kMaxSlabs
                             ? blocks_for(f, kSlab) : kMaxSlabs;
  spmm_chunk_kernel<kVec>
      <<<dim3(blocks_for(nchunk, kWarps), slabs), dim3(32, kWarps), 0,
         stream>>>(chunks, nchunk, col, val, b, z, ws, f);
  if (nsplit > 0)
    spmm_merge_kernel<kVec>
        <<<dim3(blocks_for(nsplit, kWarps), slabs), dim3(32, kWarps), 0,
           stream>>>(splits, nsplit, ws, z, f);
}

}  // namespace

// chunks int32 [4, nchunk], splits int32 [3, nsplit] (chunk_plan's), cut
// at `chunk` entries; ws float32 [parts of all split rows, f].
extern "C" int hetu_csr_spmm(const void* chunks, int64_t nchunk,
                             const void* splits, int64_t nsplit,
                             int64_t chunk, const void* col, const void* val,
                             const void* b, void* z, void* ws, int64_t f,
                             void* stream) {
  if (chunk != kSpmmChunk) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f % 4 == 0 && aligned16(b) && aligned16(z) && aligned16(ws);
  (vec ? launch_spmm<true> : launch_spmm<false>)(
      static_cast<const int*>(chunks), nchunk,
      static_cast<const int*>(splits), nsplit, static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(b),
      static_cast<float*>(z), static_cast<float*>(ws), f,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// the same plan; ws float32 [parts of all split rows]
extern "C" int hetu_csr_spmv(const void* chunks, int64_t nchunk,
                             const void* splits, int64_t nsplit,
                             int64_t chunk, const void* col, const void* val,
                             const void* x, void* z, void* ws, void* stream) {
  if (chunk != kSpmvChunk) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  spmv_chunk_kernel<<<blocks_for(nchunk, kThreads), kThreads, 0, s>>>(
      static_cast<const int*>(chunks), nchunk, static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<float*>(z), static_cast<float*>(ws));
  if (nsplit > 0)
    spmv_merge_kernel<<<blocks_for(nsplit, kWarps), dim3(32, kWarps), 0, s>>>(
        static_cast<const int*>(splits), nsplit,
        static_cast<const float*>(ws), static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}
