// Sorted segment sum of embedding row gradients for Hopper (sm_90a):
// fused_embed_grad.
//
// Port of the TPU kernel hetu_tpu/kernels/embed_grad.py:_segsum_pallas (body
// _segsum_kernel). The caller has stable-sorted the batch's row gradients by
// row id (sv, (n, d) float32), so each unique row's gradients form one
// contiguous run; offs (int32, n + 1 entries) marks the runs: segment k is
// rows [offs[k], offs[k + 1]), and offs[k] = n for k >= count, so the
// segments past the last unique row are empty. The kernel writes
//
//     out[k, :] = sum over j in [offs[k], offs[k + 1]), in j order, of sv[j, :]
//
// for every k < n: the unique rows' gradient sums first, zeros after.
//
// Summation order. Each output element is ONE float32 accumulator, started
// at 0 and updated acc = acc + sv[j] over the segment's rows in j order
// (the stable sort keeps the batch's order within a row id), then written
// once. The plain PyTorch version
// (hetu_tpu_torch/kernels/embed_grad.py:_segsum_plain) adds the same rows
// in the same order, so the two agree bit for bit. No atomics: a CUDA
// atomic adds in the order the threads arrive, which changes from run to
// run.
//
// Ownership. The TPU kernel computes out = M · sv with a 0/1 mask matrix M
// on the MXU, 128 output rows a grid step, the whole of sv resident in VMEM.
// Here one block owns one output row k (a grid-stride loop over k) and its
// threads stride over d, so any d >= 1 is served; nothing is shared between
// blocks and the result does not depend on scheduling. The TPU's 128-row
// tile, its d % 128 lane rule and its VMEM budget have no counterpart.
// Each thread issues the loads of kUnroll rows before their adds, which run
// in j order: more loads in flight, the same sum.
//
// Bound. Bytes: read sv and offs once, write out once (at WDL-Criteo's
// n = 3,328, d = 128: 3.4 MB, about 1 us at 3.35 TB/s); n * d adds at most.
// A long run (one id repeated) is serial in one block: right first, faster
// designs later (warps split across long runs, vectorized loads, the
// scatter into the table fused in).
//
// Offsets j * d and k * d are 64-bit. C interface for ctypes: the function
// returns cudaGetLastError() after its launch (0 on success) and launches
// on the given stream; the caller passes n >= 1 and d >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 65535;

__global__ void segsum_kernel(const float* __restrict__ sv,
                              const int* __restrict__ offs,
                              float* __restrict__ out, int64_t n, int64_t d) {
  for (int64_t k = blockIdx.x; k < n; k += gridDim.x) {
    const int start = offs[k];
    const int end = offs[k + 1];
    float* ok = out + k * d;
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
      const float* col = sv + c;
      float acc = 0.0f;
      int j = start;
      // kUnroll rows at a time: all their loads first, then the adds in j
      // order, so the sum is the same as one row at a time
      for (; j + kUnroll <= end; j += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = col[static_cast<int64_t>(j + u) * d];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = acc + x[u];
      }
      for (; j < end; ++j) acc = acc + col[static_cast<int64_t>(j) * d];
      ok[c] = acc;
    }
  }
}

}  // namespace

extern "C" int hetu_embed_grad_segsum(const void* sv, const void* offs,
                                      void* out, int64_t n, int64_t d,
                                      void* stream) {
  // threads: d rounded up to whole warps, at most kMaxThreads
  const int64_t warps = (d + 31) / 32;
  const int threads =
      static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  const unsigned int blocks =
      static_cast<unsigned int>(n < kMaxBlocks ? n : kMaxBlocks);
  segsum_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sv), static_cast<const int*>(offs),
      static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}
