// Blockwise quantize and dequantize of the quantized data-parallel gradient
// all-reduce for Hopper (sm_90a): quant_blocks and dequant_blocks.
//
// Ports of the TPU kernels hetu_tpu/kernels/quant_comm.py:_quant_pallas
// (body _quant_kernel) and :_dequant_pallas (body _dequant_kernel). The flat
// float32 shard x of n elements is cut into nb = ceil(n / block) blocks of
// `block` elements; elements at or past n read as 0 (the reference pads with
// zeros; here no padded copy is made). Per block:
//
//     amax  = max |x|              (a NaN anywhere makes amax NaN)
//     scale = amax / Q             (Q = 127 int8, 448 fp8 e4m3fn)
//     safe  = scale > 0 ? scale : 1
//     int8: q = clamp(rint(x / safe), -127, 127)   (round half to even)
//     fp8:  q = e4m3fn(x / safe)                   (round to nearest even,
//                                                   saturating to +-448)
//
// and the dequantize writes out[i] = float(q[i]) * scale[i / block] for the
// first n elements only.
//
// Wire contract. The payload crosses the wire to peers, so it must equal the
// plain PyTorch version (hetu_tpu_torch/kernels/quant_comm.py:_quant_plain)
// and the reference's comm_quant.quantize_blocks bit for bit. Hence:
// - x / safe is an IEEE division (the build has no --use_fast_math, so
//   `/` on floats is correctly rounded), never a multiply by 1 / safe;
// - int8 rounds with __float2int_rn (half to even, NaN to 0) and clamps
//   after rounding, as the plain version's round-then-clamp;
// - fp8 converts with __nv_cvt_float_to_fp8(..., __NV_SATFINITE, __NV_E4M3):
//   x / safe can exceed 448 by an ulp (448.00003), which must become 448,
//   as the plain cast rounds it; -0.0 becomes 0x80, NaN 0x7f;
// - the max propagates NaN as torch.amax and jnp.max do (fmaxf alone would
//   drop it): a block holding a NaN gets a NaN scale and dequantizes to NaN.
//
// Ownership. The TPU kernel holds the whole (nb, block) shard in VMEM and
// reduces each row. Here one warp owns one quantization block: its lanes
// stride over the block (any block >= 1), reduce |x| with shuffles, and the
// same lanes then divide, convert and store. Eight warps a CTA, and a
// grid-stride loop over blocks, so nb past 65,535 needs no second grid
// dimension. Nothing is shared between warps and no order arises: the max
// is exact in any order.
//
// Bound. Bytes: the quantize reads x (4n) and writes q (n) and the scales
// (4 nb); the dequantize reads q and the scales and writes out (4n). At the
// MLP's largest gradient (786,432 elements) that is 3.9 MB, about 1.2 us at
// 3.35 TB/s, below a launch's latency; at a BERT-base-sized 110 M elements
// 0.55 GB, 0.16 ms. The quantize reads each block twice (the second time
// from L1/L2) and stores one byte a lane: right first, wider stores later.
//
// C interface for ctypes: each function returns cudaGetLastError() after
// its launch (0 on success) and launches on the given stream; the caller
// passes n >= 1, block >= 1 and nb = ceil(n / block) or more blocks.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int64_t kMaxCtas = 65535;
constexpr unsigned kAll = 0xffffffffu;

unsigned int ctas_for(int64_t nb) {
  const int64_t c = (nb + kWarps - 1) / kWarps;
  return static_cast<unsigned int>(c < kMaxCtas ? c : kMaxCtas);
}

template <bool kFp8>
__global__ void quant_kernel(const float* __restrict__ x,
                             uint8_t* __restrict__ q,
                             float* __restrict__ scales, int64_t n,
                             int64_t block, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       b < nb; b += stride) {
    const int64_t base = b * block;
    float m = 0.0f;
    bool nan = false;
    for (int64_t i = lane; i < block; i += 32) {
      const float v = base + i < n ? x[base + i] : 0.0f;
      nan = nan || v != v;
      m = fmaxf(m, fabsf(v));
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
    const float amax = __any_sync(kAll, nan) ? __int_as_float(0x7fc00000) : m;
    const float scale = amax / (kFp8 ? 448.0f : 127.0f);
    const float safe = scale > 0.0f ? scale : 1.0f;
    if (lane == 0) scales[b] = scale;
    for (int64_t i = lane; i < block; i += 32) {
      const float v = (base + i < n ? x[base + i] : 0.0f) / safe;
      uint8_t out;
      if (kFp8) {
        out = static_cast<uint8_t>(
            __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
      } else {
        const int r = min(max(__float2int_rn(v), -127), 127);
        out = static_cast<uint8_t>(static_cast<int8_t>(r));
      }
      q[base + i] = out;
    }
  }
}

template <bool kFp8>
__global__ void dequant_kernel(const uint8_t* __restrict__ q,
                               const float* __restrict__ scales,
                               float* __restrict__ out, int64_t n,
                               int64_t block, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       b < nb; b += stride) {
    const int64_t base = b * block;
    const float s = scales[b];
    for (int64_t i = lane; i < block && base + i < n; i += 32) {
      const uint8_t raw = q[base + i];
      float v;
      if (kFp8) {
        v = __half2float(__half(__nv_cvt_fp8_to_halfraw(raw, __NV_E4M3)));
      } else {
        v = static_cast<float>(static_cast<int8_t>(raw));
      }
      out[base + i] = v * s;
    }
  }
}

}  // namespace

extern "C" int hetu_quant_blocks(const void* x, void* q, void* scales,
                                 int64_t n, int64_t block, int64_t nb,
                                 int fp8, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto qp = static_cast<uint8_t*>(q);
  auto sp = static_cast<float*>(scales);
  if (fp8)
    quant_kernel<true><<<ctas_for(nb), kThreads, 0, s>>>(xp, qp, sp, n, block,
                                                         nb);
  else
    quant_kernel<false><<<ctas_for(nb), kThreads, 0, s>>>(xp, qp, sp, n,
                                                          block, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetu_dequant_blocks(const void* q, const void* scales,
                                   void* out, int64_t n, int64_t block,
                                   int fp8, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const uint8_t*>(q);
  auto sp = static_cast<const float*>(scales);
  auto op = static_cast<float*>(out);
  // only the blocks that hold one of the first n elements
  const int64_t nb = (n + block - 1) / block;
  if (fp8)
    dequant_kernel<true><<<ctas_for(nb), kThreads, 0, s>>>(qp, sp, op, n,
                                                           block, nb);
  else
    dequant_kernel<false><<<ctas_for(nb), kThreads, 0, s>>>(qp, sp, op, n,
                                                            block, nb);
  return static_cast<int>(cudaGetLastError());
}
