// Tensor-core building blocks for Hopper (sm_90a), shared by the bf16
// kernels of fused_ce.cu and flash_attention.cu, forward and backward.
// Every PTX instruction the kernels issue is wrapped here, so that a
// kernel's index arithmetic reads as plain C++:
// - cp.async: 16-byte (and 4-byte) copies from device memory into shared
//   memory, with zero fill, in commit groups;
// - ldmatrix and mma.sync.m16n8k16 (bf16 in, f32 accumulate): the warp-level
//   tiles of flash attention;
// - wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate in registers), its
//   shared-memory descriptors and fences: the warpgroup-level tiles of the
//   fused linear+CE.
//
// Shared-memory layout of a wgmma operand ("swizzled lines"). An operand
// tile is a run of 128-byte lines, each holding 64 bf16 values, the tile
// base aligned to 1024 bytes. The 16-byte chunk c of line l is stored at
// byte l*128 + ((c ^ (l % 8)) * 16): the 128-byte swizzle, which the
// hardware undoes from the address bits (layout type 1 of the descriptor),
// and under which the eight chunks of a line and the same chunk of eight
// lines all fall in different banks. What a line holds depends on the
// operand's major mode:
// - K-major (the depth k contiguous in device memory): line l is row l of
//   the M or N extent, its 64 values are k = 0..63 of the 64-deep stage.
//   Descriptor: SBO = 1024 (the next 8 rows), LBO unused (16); one k16 step
//   of the instruction advances the start address by 32 bytes.
// - MN-major (M or N contiguous): line (b*64 + k) holds values mn = b*64 ..
//   b*64+63 at depth k. Descriptor: SBO = 1024 (the next 8 depths), LBO =
//   64 lines = 8192 bytes (the next 64 of M or N); one k16 step advances the
//   start address by 16 lines, 2048 bytes.
// A 128 x 64 stage of either mode is 128 lines, 16 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async ---------------------------------------------------------------

// 16 bytes from src to dst; only the first src_bytes are read, the rest of
// the 16 is zero (src_bytes = 0: 16 zero bytes, src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes from src to dst, as cp_async16 (src_bytes 0 or 4).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's commit groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Writes of the generic proxy (cp.async, st.shared) made visible to the
// async proxy that wgmma reads shared memory through; each writing thread
// issues it before the barrier that hands the tile to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(void* dst, uint4 v) {
  *static_cast<uint4*>(dst) = v;
}

// -- bf16 packing -------------------------------------------------------------

// Two floats rounded to bf16 (round to nearest even) in one 32-bit
// register: lo in the low half, the element of the lower column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- ldmatrix and mma.sync (warp level) --------------------------------------

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and r[j] receives its fragment of matrix j (row lane/4, columns
// 2*(lane%4) and +1; with trans, the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col). Fragments:
// a[0] (row g, cols 2t..2t+1), a[1] (row g+8), a[2] (row g, cols +8),
// a[3] (row g+8, cols +8); b0 (k 2t..2t+1, col g), b1 (k +8);
// c[0..1] (row g, cols 2t..2t+1), c[2..3] (row g+8); g = lane/4, t = lane%4.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- wgmma (warpgroup level) -------------------------------------------------

// The descriptor of a swizzled-lines operand (see the header) whose first
// line is at p; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;   // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// d (64x128 f32, this warpgroup's registers) += A (64x16) . B (16x128), A
// and B bf16 in shared memory by their descriptors. kTransA / kTransB: 0
// for a K-major operand, 1 for an MN-major one. Thread t of the warpgroup
// holds, for j < 64, d[j] at row 16*(t/32) + (t%32)/4 + 8*((j/2)%2) and
// column 8*(j/4) + 2*(t%4) + j%2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma: each register is "used and redefined" here.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace tc
