// Blockwise quantize and dequantize of the quantized data-parallel gradient
// all-reduce for Hopper (sm_90a): quant_blocks and dequant_blocks, each one
// launch per step over every quantized gradient of an optimizer node.
//
// Ports of the TPU kernels hetu_tpu/kernels/quant_comm.py:_quant_pallas
// (body _quant_kernel) and :_dequant_pallas (body _dequant_kernel).
//
// Quantize (hetu_quant_group). The flat float32 vector x of n elements (the
// rank's reduce-scattered shard of a group: one shard per tensor,
// concatenated) is cut into nb blocks of `block` elements; elements at or
// past n read as 0 (a single tensor's ragged tail; a group's shard is
// padded to whole blocks). Per element, first the prologue of the
// all-reduce:
//
//     v = x / dp                   (an IEEE quotient; skipped at dp = 1,
//                                   where it is the identity)
//     v = v + r_in                 (error feedback, when r_in is given)
//
// then per block:
//
//     amax  = max |v|              (a NaN anywhere makes amax NaN)
//     scale = amax / Q             (Q = 127 int8, 448 fp8 e4m3fn)
//     safe  = scale > 0 ? scale : 1
//     int8: q = clamp(rint(v / safe), -127, 127)   (round half to even)
//     fp8:  q = e4m3fn(v / safe)                   (round to nearest even,
//                                                   saturating to +-448)
//     r_out = v - float(q) * scale (the new residual, when r_out is given)
//
// The new residual equals the shard minus its dequantized self, bit for
// bit: the dequantize multiplies the same q by the same scale, and
// -fmad=false keeps the product and the difference two roundings.
//
// The mean. PyTorch on a CUDA tensor computes `t / python_int` as a product
// with the rounded reciprocal; on the CPU it takes the IEEE quotient. Both
// here and in the plain version (kernels/quant_comm.py:_mean) the mean is
// the IEEE quotient. At dp = 1, 2, 4 or 8 the reciprocal is exact, so the
// two forms agree; at dp = 3 they may differ by an ulp.
//
// Dequantize (hetu_dequant_group). It reads the all-gathered payload and
// scales of all dp ranks (rank r's q at q + r * q_stride, its scales at
// scales + r * s_stride) and writes, for each tensor p of the plan, only its
// first n_p values, into out + out_off[p]: a param-major float32 vector.
// Global block g in [0, dp * nb) is rank r = g / nb's local block b = g % nb;
// its tensor p is found by a binary search over the plan's first blocks
// (the largest p with first[p] <= b), so a plan of any number of tensors
// lives in device memory and there is no cap. The block's element index in
// p is i0 = r * S_p + (b - first[p]) * block, and a block with i0 >= n_p (a
// shard's zero padding) writes nothing.
//
// Plan (kernels/quant_comm.py:qar_plan), int64 in device memory, read as
// given: first[0..P] (first block of each tensor in the rank's shard;
// first[P] = nb), n[0..P-1], S[0..P-1] (each tensor's shard, a multiple of
// block), out_off[0..P-1] (a multiple of 4, so every tensor's output starts
// 16-byte aligned).
//
// Wire contract. The payload crosses the wire to peers, so it must equal the
// plain PyTorch version (hetu_tpu_torch/kernels/quant_comm.py:_quant_plain)
// and the reference's comm_quant.quantize_blocks bit for bit. Hence:
// - v / safe is an IEEE division (the build has no --use_fast_math, so
//   `/` on floats is correctly rounded), never a multiply by 1 / safe;
// - int8 rounds with __float2int_rn (half to even, NaN to 0) and clamps
//   after rounding, as the plain version's round-then-clamp;
// - fp8 converts with __nv_cvt_float_to_fp8(..., __NV_SATFINITE, __NV_E4M3):
//   v / safe can exceed 448 by an ulp (448.00003), which must become 448,
//   as the plain cast rounds it; -0.0 becomes 0x80, NaN 0x7f;
// - the max propagates NaN as torch.amax and jnp.max do (fmaxf alone would
//   drop it): a block holding a NaN gets a NaN scale, a NaN residual and
//   dequantizes to NaN.
//
// Ownership. One warp owns one quantization block, eight warps a CTA, and a
// grid-stride loop over blocks, so nb past 65,535 needs no second grid
// dimension. Where block = 32 * E with E in {2, 4, 8} (blocks 64, 128 and
// 256, the default and the main path's) and the pointers allow it, each
// lane owns E elements, in runs of 4 (E = 2: one run of 2) so that each
// warp-wide access covers contiguous memory (Lanes<E>): the quantize
// loads them with 16-byte (E = 2: 8-byte) accesses and keeps them in
// registers, so x is read once, reads and writes the residual the same
// way, and stores each run's payload bytes as one 4-byte (2-byte) store;
// the dequantize loads a run's bytes at once (fp8 decoded in pairs with
// __nv_cvt_fp8x2_to_halfraw2) and stores 16-byte (8-byte) vectors. A lane
// owning 8 consecutive elements instead (two 16-byte stores 32 bytes
// apart, each warp-wide store writing half of every 32-byte sector) ran
// the dequantize at 49 % of its bound at 110 M elements on the H100,
// against 69 % for the scalar stores of one element a lane. Any other
// block, or a pointer the vectors cannot take, runs the scalar path: lanes
// stride over the block, and the quantize reads x twice (the second time
// from L1/L2). Nothing is shared between warps and no order arises: the
// max is exact in any order.
//
// Bound. Bytes: the quantize reads x (4n) and, with error feedback, the
// residual (4n), and writes q (n), the scales (4 nb) and the residual (4n):
// 13n + 4nb with error feedback, 5n + 4nb without. The dequantize reads the
// kept q and scales (n + 4nb) and writes 4n.
//
// C interface for ctypes: each function returns cudaGetLastError() after
// its launch (0 on success) and launches on the given stream; the caller
// passes n >= 1, block >= 1, nb = ceil(n / block) or more blocks, and
// vec_elems 0 (scalar) or block / 32 where the pointers allow it.

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

__device__ __forceinline__ float mean_of(float x, int64_t dp) {
  return dp > 1 ? x / static_cast<float>(dp) : x;
}

// amax over the warp, NaN kept
__device__ __forceinline__ float warp_amax(float m, bool nan) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
  return __any_sync(kAll, nan) ? __int_as_float(0x7fc00000) : m;
}

template <bool kFp8>
__device__ __forceinline__ uint8_t encode(float v) {
  if (kFp8)
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  const int r = min(max(__float2int_rn(v), -127), 127);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

template <bool kFp8>
__device__ __forceinline__ float decode(uint8_t raw) {
  if (kFp8)
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(raw, __NV_E4M3)));
  return static_cast<float>(static_cast<int8_t>(raw));
}

// The vector paths' lane mapping: a block of 32 * E elements is E / W
// chunks of 32 * W, W = 4 (W = 2 where E = 2); in chunk c lane l owns the W
// consecutive elements from c * 32 * W + l * W. So each warp-wide access
// covers 32 * W contiguous elements: whole 32-byte sectors, loads and
// stores alike.
template <int E>
struct Lanes {
  static constexpr int W = E == 2 ? 2 : 4;
  static constexpr int C = E / W;
  __device__ static int64_t off(int c, int lane) {
    return static_cast<int64_t>(c) * 32 * W + lane * W;
  }
};

// W floats from an address aligned to 4 * W bytes
template <int W>
__device__ __forceinline__ void load_w(const float* p, float* v) {
  if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float* v) {
  if constexpr (W == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// W payload bytes, little-endian, as one W-byte access
template <int W>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint8_t* b) {
  if constexpr (W == 2)
    *reinterpret_cast<uint16_t*>(p) =
        static_cast<uint16_t>(b[0] | (b[1] << 8));
  else
    *reinterpret_cast<uint32_t*>(p) =
        b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<uint32_t>(b[3]) << 24);
}

template <int W>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t* b) {
  const uint32_t w = W == 2 ? *reinterpret_cast<const uint16_t*>(p)
                            : *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < W; ++k) b[k] = (w >> (8 * k)) & 0xff;
}

// W decoded values; fp8 in pairs
template <bool kFp8, int W>
__device__ __forceinline__ void decode_w(const uint8_t* b, float* v) {
#pragma unroll
  for (int k = 0; k < W; k += 2) {
    if (kFp8) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>(b[k] | (b[k + 1] << 8));
      const float2 f =
          __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
      v[k] = f.x;
      v[k + 1] = f.y;
    } else {
      v[k] = static_cast<float>(static_cast<int8_t>(b[k]));
      v[k + 1] = static_cast<float>(static_cast<int8_t>(b[k + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// quantize
// ---------------------------------------------------------------------------

// scalar path: any block; reads x twice
template <bool kFp8>
__global__ void quant_kernel(const float* __restrict__ x,
                             const float* __restrict__ r_in,
                             float* __restrict__ r_out,
                             uint8_t* __restrict__ q,
                             float* __restrict__ scales, int64_t n,
                             int64_t block, int64_t nb, int64_t dp) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       b < nb; b += stride) {
    const int64_t base = b * block;
    float m = 0.0f;
    bool nan = false;
    for (int64_t i = lane; i < block; i += 32) {
      float v = 0.0f;
      if (base + i < n) {
        v = mean_of(x[base + i], dp);
        if (r_in) v = v + r_in[base + i];
      }
      nan = nan || v != v;
      m = fmaxf(m, fabsf(v));
    }
    const float amax = warp_amax(m, nan);
    const float scale = amax / (kFp8 ? 448.0f : 127.0f);
    const float safe = scale > 0.0f ? scale : 1.0f;
    if (lane == 0) scales[b] = scale;
    for (int64_t i = lane; i < block; i += 32) {
      float v = 0.0f;
      if (base + i < n) {
        v = mean_of(x[base + i], dp);
        if (r_in) v = v + r_in[base + i];
      }
      const uint8_t out = encode<kFp8>(v / safe);
      q[base + i] = out;
      if (r_out && base + i < n)
        r_out[base + i] = v - decode<kFp8>(out) * scale;
    }
  }
}

// vector path: block = 32 * E, each lane's E elements (Lanes<E>) held in
// registers; x, r_in, r_out and q aligned to 16 bytes
template <bool kFp8, int E>
__global__ void quant_vec_kernel(const float* __restrict__ x,
                                 const float* __restrict__ r_in,
                                 float* __restrict__ r_out,
                                 uint8_t* __restrict__ q,
                                 float* __restrict__ scales, int64_t n,
                                 int64_t nb, int64_t dp) {
  using L = Lanes<E>;
  constexpr int W = L::W, C = L::C;
  constexpr int64_t kBlock = 32 * E;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       b < nb; b += stride) {
    const int64_t base = b * kBlock;
    const bool whole = base + kBlock <= n;
    float v[E];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t at = base + L::off(c, lane);
      if (whole) {
        load_w<W>(x + at, v + c * W);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          v[c * W + k] = at + k < n ? x[at + k] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = mean_of(v[k], dp);
    if (r_in) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int64_t at = base + L::off(c, lane);
        float r[W];
        if (whole) {
          load_w<W>(r_in + at, r);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) r[k] = at + k < n ? r_in[at + k] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (at + k < n) v[c * W + k] = v[c * W + k] + r[k];
      }
    }
    float m = 0.0f;
    bool nan = false;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      nan = nan || v[k] != v[k];
      m = fmaxf(m, fabsf(v[k]));
    }
    const float amax = warp_amax(m, nan);
    const float scale = amax / (kFp8 ? 448.0f : 127.0f);
    const float safe = scale > 0.0f ? scale : 1.0f;
    if (lane == 0) scales[b] = scale;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t at = base + L::off(c, lane);
      uint8_t out[W];
#pragma unroll
      for (int k = 0; k < W; ++k) out[k] = encode<kFp8>(v[c * W + k] / safe);
      store_bytes<W>(q + at, out);
      if (r_out) {
        float dq[W];
        decode_w<kFp8, W>(out, dq);
        float r[W];
#pragma unroll
        for (int k = 0; k < W; ++k) r[k] = v[c * W + k] - dq[k] * scale;
        if (whole) {
          store_w<W>(r_out + at, r);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k)
            if (at + k < n) r_out[at + k] = r[k];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dequantize
// ---------------------------------------------------------------------------

struct Plan {
  const int64_t* first;    // P + 1
  const int64_t* n;        // P
  const int64_t* size;     // P: S_p
  const int64_t* out_off;  // P
  int64_t tensors;
};

__device__ __forceinline__ Plan plan_of(const int64_t* plan, int64_t p) {
  return Plan{plan, plan + p + 1, plan + 2 * p + 1, plan + 3 * p + 1, p};
}

// the tensor of local block b: the largest t with first[t] <= b
__device__ __forceinline__ int64_t tensor_of(const Plan& pl, int64_t b) {
  int64_t lo = 0, hi = pl.tensors - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (pl.first[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// where global block g writes: its tensor's n, the block's first element
// index in the tensor, and the element's base in out; false when the block
// holds only the shard's padding
struct Where {
  int64_t n, i0, out, qb, sb;
};

__device__ __forceinline__ bool block_where(const Plan& pl, int64_t g,
                                            int64_t nb, int64_t block,
                                            int64_t q_stride,
                                            int64_t s_stride, Where& w) {
  const int64_t r = g / nb, b = g - r * nb;
  const int64_t t = tensor_of(pl, b);
  w.n = pl.n[t];
  w.i0 = r * pl.size[t] + (b - pl.first[t]) * block;
  w.out = pl.out_off[t];
  w.qb = r * q_stride + b * block;
  w.sb = r * s_stride + b;
  return w.i0 < w.n;
}

template <bool kFp8>
__global__ void dequant_kernel(const uint8_t* __restrict__ q,
                               int64_t q_stride,
                               const float* __restrict__ scales,
                               int64_t s_stride, float* __restrict__ out,
                               const int64_t* __restrict__ plan,
                               int64_t tensors, int64_t nb, int64_t block,
                               int64_t dp) {
  const int lane = threadIdx.x & 31;
  const Plan pl = plan_of(plan, tensors);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       g < dp * nb; g += stride) {
    Where w;
    if (!block_where(pl, g, nb, block, q_stride, s_stride, w)) continue;
    const float s = scales[w.sb];
    for (int64_t k = lane; k < block && w.i0 + k < w.n; k += 32)
      out[w.out + w.i0 + k] = decode<kFp8>(q[w.qb + k]) * s;
  }
}

// vector path: block = 32 * E, each lane's E elements (Lanes<E>); q and out
// aligned to 16 bytes, every out_off a multiple of 4
template <bool kFp8, int E>
__global__ void dequant_vec_kernel(const uint8_t* __restrict__ q,
                                   int64_t q_stride,
                                   const float* __restrict__ scales,
                                   int64_t s_stride, float* __restrict__ out,
                                   const int64_t* __restrict__ plan,
                                   int64_t tensors, int64_t nb, int64_t dp) {
  using L = Lanes<E>;
  constexpr int W = L::W, C = L::C;
  constexpr int64_t kBlock = 32 * E;
  const int lane = threadIdx.x & 31;
  const Plan pl = plan_of(plan, tensors);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       g < dp * nb; g += stride) {
    Where w;
    if (!block_where(pl, g, nb, kBlock, q_stride, s_stride, w)) continue;
    const float s = scales[w.sb];
    uint8_t raw[E];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (w.i0 + L::off(c, lane) < w.n)
        load_bytes<W>(q + w.qb + L::off(c, lane), raw + c * W);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t i = w.i0 + L::off(c, lane);
      if (i >= w.n) continue;
      float v[W];
      decode_w<kFp8, W>(raw + c * W, v);
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] = v[k] * s;
      float* dst = out + w.out + i;
      if (i + W <= w.n) {
        store_w<W>(dst, v);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (i + k < w.n) dst[k] = v[k];
      }
    }
  }
}

template <bool kFp8>
cudaError_t launch_quant(const float* x, const float* ri, float* ro,
                         uint8_t* q, float* sc, int64_t n, int64_t block,
                         int64_t nb, int64_t dp, int vec, cudaStream_t s) {
  const unsigned g = ctas_for(nb);
  switch (vec) {
    case 2:
      quant_vec_kernel<kFp8, 2><<<g, kThreads, 0, s>>>(x, ri, ro, q, sc, n,
                                                        nb, dp);
      break;
    case 4:
      quant_vec_kernel<kFp8, 4><<<g, kThreads, 0, s>>>(x, ri, ro, q, sc, n,
                                                        nb, dp);
      break;
    case 8:
      quant_vec_kernel<kFp8, 8><<<g, kThreads, 0, s>>>(x, ri, ro, q, sc, n,
                                                        nb, dp);
      break;
    case 0:
      quant_kernel<kFp8><<<g, kThreads, 0, s>>>(x, ri, ro, q, sc, n, block,
                                                nb, dp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kFp8>
cudaError_t launch_dequant(const uint8_t* q, int64_t qs, const float* sc,
                           int64_t ss, float* out, const int64_t* plan,
                           int64_t tensors, int64_t nb, int64_t block,
                           int64_t dp, int vec, cudaStream_t s) {
  const unsigned g = ctas_for(dp * nb);
  switch (vec) {
    case 2:
      dequant_vec_kernel<kFp8, 2><<<g, kThreads, 0, s>>>(q, qs, sc, ss, out,
                                                          plan, tensors, nb,
                                                          dp);
      break;
    case 4:
      dequant_vec_kernel<kFp8, 4><<<g, kThreads, 0, s>>>(q, qs, sc, ss, out,
                                                          plan, tensors, nb,
                                                          dp);
      break;
    case 8:
      dequant_vec_kernel<kFp8, 8><<<g, kThreads, 0, s>>>(q, qs, sc, ss, out,
                                                          plan, tensors, nb,
                                                          dp);
      break;
    case 0:
      dequant_kernel<kFp8><<<g, kThreads, 0, s>>>(q, qs, sc, ss, out, plan,
                                                  tensors, nb, block, dp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: n floats; r_in, r_out: n floats each, or null (no error feedback);
// q: nb * block bytes; scales: nb floats; dp >= 1; vec 0, or block / 32
// in {2, 4, 8} with block = 32 * vec (the caller checks the alignment)
extern "C" int hetu_quant_group(const void* x, const void* r_in, void* r_out,
                                void* q, void* scales, int64_t n,
                                int64_t block, int64_t nb, int64_t dp,
                                int fp8, int vec, void* stream) {
  if (vec != 0 && block != 32 * static_cast<int64_t>(vec))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto ri = static_cast<const float*>(r_in);
  auto ro = static_cast<float*>(r_out);
  auto qp = static_cast<uint8_t*>(q);
  auto sp = static_cast<float*>(scales);
  const cudaError_t rc =
      fp8 ? launch_quant<true>(xp, ri, ro, qp, sp, n, block, nb, dp, vec, s)
          : launch_quant<false>(xp, ri, ro, qp, sp, n, block, nb, dp, vec, s);
  return static_cast<int>(rc);
}

// q: dp rows of at least nb * block bytes, q_stride bytes apart; scales: dp
// rows of at least nb floats, s_stride floats apart; plan: 4 * tensors + 1
// int64 in device memory (see the header); out: the plan's param-major
// output
extern "C" int hetu_dequant_group(const void* q, int64_t q_stride,
                                  const void* scales, int64_t s_stride,
                                  void* out, const void* plan,
                                  int64_t tensors, int64_t nb, int64_t block,
                                  int64_t dp, int fp8, int vec,
                                  void* stream) {
  if (vec != 0 && block != 32 * static_cast<int64_t>(vec))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const uint8_t*>(q);
  auto sp = static_cast<const float*>(scales);
  auto op = static_cast<float*>(out);
  auto pl = static_cast<const int64_t*>(plan);
  const cudaError_t rc =
      fp8 ? launch_dequant<true>(qp, q_stride, sp, s_stride, op, pl, tensors,
                                 nb, block, dp, vec, s)
          : launch_dequant<false>(qp, q_stride, sp, s_stride, op, pl, tensors,
                                  nb, block, dp, vec, s);
  return static_cast<int>(rc);
}
