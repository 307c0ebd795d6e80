// Sorted segment sum of embedding row gradients for Hopper (sm_90a):
// fused_embed_grad.
//
// Port of the TPU kernel hetu_tpu/kernels/embed_grad.py:_segsum_pallas (body
// _segsum_kernel). vec (m, d) float32 holds a batch's row gradients in batch
// order; order (m entries, int64) is the stable sort of their row ids
// (torch.sort) and key (m entries, int32) the sorted keys: sorted row j is
// vec[order[j]] and belongs to output row key[j]. The keys are
// nondecreasing, so each output row's gradients are one contiguous run of
// the sorted order, a segment. The kernel writes
//
//     out[k, :] = the sum of vec[order[j], :] over the j with key[j] = k
//
// for every key k in [0, out_rows). Rows of out that no key names are not
// written (the caller zeroes them); a key outside [0, out_rows) is dropped.
// The compact form (embed_grad_rows) passes the segments' ranks as keys and
// an (m, d) out; the dense form (embed_grad_dense) passes the sorted row
// ids and the (vocab, d) table gradient, so the sums land in the table.
//
// Summation order, defined here once. The sorted order is cut into chunks
// of C rows: chunk c is sorted rows [c * C, min((c + 1) * C, m)). C is the
// caller's (hetu_tpu_torch/kernels/embed_grad.py:chunk_rows, from m and d
// alone), at most kMaxChunk. A piece is a segment's rows inside one chunk.
// Each piece is summed in row order into one float32 accumulator started at
// 0 (acc = acc + x). A segment of one piece is that sum; a segment whose
// pieces lie in chunks c0 < c1 < ... is folded in chunk order,
// ((p_c0 + p_c1) + p_c2) + ... The plain PyTorch version
// (hetu_tpu_torch/kernels/embed_grad.py:_segsum_plain) adds the same values
// in the same order, so the two agree bit for bit. No atomics: a CUDA
// atomic adds in the order the threads arrive, which changes from run to
// run. The stable sort keeps the batch's order within a row id.
//
// Work split. Launch 1 (segsum_chunk_kernel): one warp per (chunk, column
// slab); a slab is 32 lanes of 4 columns (float4, where d % 4 == 0 and vec,
// out and part are 16-byte aligned: the entry chooses) or of 1. The warp stages its chunk's order
// and keys in shared memory, then walks the rows in order, the loads of
// the next kUnroll rows issued before the adds of these; its control flow
// is the same on every lane. A
// piece that is a whole segment is written to out. The piece that continues
// a segment from the chunk before (the chunk's head) goes to part[2c], the
// piece whose segment continues into the next chunk (its tail) to
// part[2c + 1]; a chunk that is one piece of a longer segment holds a head.
// Launch 2 (segsum_fold_kernel), only where there are two chunks or more:
// one warp per (chunk, 32 columns), a lane a column. The warp of a chunk
// with a tail folds its tail and the following chunks' heads in chunk
// order, up to the chunk where the segment ends, and writes the sum; each
// round loads kFoldUnroll heads together with whether the segment runs past
// each of those chunks (a key just past its end). Other warps return.
//
// Why. The TPU kernel computes out = M . sv with a 0/1 mask matrix M on the
// MXU, 128 output rows a grid step, the whole sorted copy sv resident in
// VMEM. Its first port here gave each output row to one block, which summed
// the row's run serially: a run of r rows cost about r dependent round trips
// to memory in one block, and BERT's padding id (about 4,100 rows of a phase-2
// batch) and its type ids (about 10,000 and 6,000 rows into a 2-row table)
// are such runs. Here a run is summed in pieces of at most C rows in
// parallel, and its fold reads r / C partials. Reading vec through order
// removes the sorted copy sv; writing the sums at their keys removes the
// scatter of the compact sums into the table.
//
// Bound. Bytes: vec's rows once, order (8 bytes) and key (4) once, each
// written row once; at most one add per element of vec. At BERT-base's
// phase 2 (16,384 rows, d = 768): 50.3 MB of rows, about 15 us at
// 3.35 TB/s; at WDL-Criteo's step (3,328 rows, d = 128): 1.7 MB plus the
// rows written, about 1 us, where a launch's fixed cost dominates. The
// partials (at most 2 rows a chunk) are extra traffic, in L2.
//
// Offsets are 64-bit: the full Criteo table holds 4.32e9 elements. C
// interface for ctypes: the entry returns the CUDA error of its launches (0
// on success), or cudaErrorInvalidValue for a chunk outside [1, kMaxChunk]
// or d above 65,535 * 32; it launches on the given stream. The caller passes m >= 1, d >= 1,
// a part buffer of 2 * ceil(m / C) rows of d floats and keys sorted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;         // chunks a block, one warp each
constexpr int kMaxChunk = 256;    // C at most: the staging arrays
constexpr int kUnroll = 16;       // rows a lane loads a round (two rounds
                                  // in flight: the next round's loads are
                                  // issued before this round's adds)
constexpr int kFoldUnroll = 32;   // partials a fold lane loads a round

template <int V>
struct Lanes;
template <>
struct Lanes<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x = a.x + b.x;
    a.y = a.y + b.y;
    a.z = a.z + b.z;
    a.w = a.w + b.w;
  }
};
template <>
struct Lanes<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a = a + b; }
};

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_chunk_kernel(const float* __restrict__ vec,
                        const int64_t* __restrict__ order,
                        const int* __restrict__ key, float* __restrict__ out,
                        float* __restrict__ part, int64_t m, int64_t d,
                        int64_t out_rows, int chunk) {
  using L = Lanes<V>;
  using T = typename L::T;
  __shared__ int64_t s_order[kWarps][kMaxChunk];
  __shared__ int s_key[kWarps][kMaxChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t start = c * chunk;
  if (start >= m) return;
  const int rows = static_cast<int>(m - start < chunk ? m - start : chunk);
  // the keys just before and after the chunk, loaded with the staging
  const int prev = start > 0 ? key[start - 1] : 0;
  const int next = start + rows < m ? key[start + rows] : 0;
  int64_t* ord = s_order[warp];
  int* ks = s_key[warp];
  for (int i = lane; i < rows; i += 32) {
    ord[i] = order[start + i];
    ks[i] = key[start + i];
  }
  __syncwarp();
  // the chunk's first piece continues a segment from the chunk before; its
  // last piece's segment continues into the next chunk
  const bool head = start > 0 && prev == ks[0];
  const bool tail = start + rows < m && next == ks[rows - 1];
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * 32 + lane) * V;
  const bool on = col < d;
  T acc = L::zero();
  bool first_piece = true;
  T x[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    x[u] = on && u < rows
               ? *reinterpret_cast<const T*>(vec + ord[u] * d + col)
               : L::zero();
  for (int j0 = 0; j0 < rows; j0 += kUnroll) {
    T y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + kUnroll + u;
      y[u] = on && j < rows
                 ? *reinterpret_cast<const T*>(vec + ord[j] * d + col)
                 : L::zero();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      if (j < rows) {
        L::add(acc, x[u]);
        if (j + 1 == rows || ks[j + 1] != ks[j]) {   // a piece ends at j
          float* dst = nullptr;
          if (first_piece && head)
            dst = part + 2 * c * d;
          else if (j + 1 == rows && tail)
            dst = part + (2 * c + 1) * d;
          else if (ks[j] >= 0 && ks[j] < out_rows)
            dst = out + static_cast<int64_t>(ks[j]) * d;
          if (on && dst != nullptr) *reinterpret_cast<T*>(dst + col) = acc;
          acc = L::zero();
          first_piece = false;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = y[u];
  }
}

// One lane a column: a fold is a chain of dependent adds, so its loads are
// spread over as many lanes as there are columns, kFoldUnroll a round.
__global__ void __launch_bounds__(kWarps * 32)
    segsum_fold_kernel(const int* __restrict__ key,
                       const float* __restrict__ part,
                       float* __restrict__ out, int64_t m, int64_t d,
                       int64_t out_rows, int chunk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t start = c * chunk;
  if (start >= m) return;
  const int64_t end = m - start < chunk ? m : start + chunk;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * 32 + lane;
  if (col >= d) return;
  // the tail slot is read with the keys that say whether it was written
  float acc = part[(2 * c + 1) * d + col];
  const int k = key[end - 1];
  // this chunk holds a tail: the segment of its last piece continues into
  // the next chunk, and the chunk is not one piece of a segment begun before
  if (end == m || key[end] != k) return;
  if (start > 0 && key[start - 1] == k && key[start] == k) return;
  const int64_t chunks = (m + chunk - 1) / chunk;
  // each round loads the heads of the next kFoldUnroll chunks and whether
  // the segment runs past each; it adds heads up to the chunk where it ends
  for (int64_t c0 = c + 1;; c0 += kFoldUnroll) {
    float x[kFoldUnroll];
    bool more[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      const int64_t cc = c0 + u, e = (cc + 1) * chunk;
      x[u] = cc < chunks ? part[2 * cc * d + col] : 0.0f;
      more[u] = e < m && key[e] == k;
    }
    bool done = false;
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      if (!done) {
        acc = acc + x[u];
        done = !more[u];
      }
    if (done) break;
  }
  if (k >= 0 && k < out_rows) out[static_cast<int64_t>(k) * d + col] = acc;
}

template <int V>
int launch(const void* vec, const void* order, const void* key, void* out,
           void* part, int64_t m, int64_t d, int64_t out_rows, int chunk,
           cudaStream_t stream) {
  const int64_t chunks = (m + chunk - 1) / chunk;
  const int64_t slabs = (d + 32 * V - 1) / (32 * V);
  const int64_t fold_slabs = (d + 31) / 32;
  if (fold_slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((chunks + kWarps - 1) / kWarps);
  segsum_chunk_kernel<V>
      <<<dim3(blocks, static_cast<unsigned int>(slabs)), kWarps * 32, 0,
         stream>>>(static_cast<const float*>(vec),
                   static_cast<const int64_t*>(order),
                   static_cast<const int*>(key), static_cast<float*>(out),
                   static_cast<float*>(part), m, d, out_rows, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  segsum_fold_kernel<<<dim3(blocks, static_cast<unsigned int>(fold_slabs)),
                       kWarps * 32, 0, stream>>>(
      static_cast<const int*>(key), static_cast<const float*>(part),
      static_cast<float*>(out), m, d, out_rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int hetu_embed_grad_segsum(const void* vec, const void* order,
                                      const void* key, void* out, void* part,
                                      int64_t m, int64_t d, int64_t out_rows,
                                      int64_t chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(chunk);
  if (d % 4 == 0 && aligned16(vec) && aligned16(out) && aligned16(part))
    return launch<4>(vec, order, key, out, part, m, d, out_rows, c, s);
  return launch<1>(vec, order, key, out, part, m, d, out_rows, c, s);
}
