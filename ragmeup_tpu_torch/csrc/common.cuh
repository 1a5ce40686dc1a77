// Helpers shared by the kernels under csrc/: conversions between the
// activation types (float, bf16) and f32, the rounding of a dequantized
// weight to the activation type, int8 weights as exact f32 or bf16 values
// without the conversion unit, the signed nibbles of packed int4 (one at
// a time, or two at once as exact bf16 integers without the conversion
// unit), the 16-byte read-only weight load, the sm_80+ instructions the
// tensor-core kernels are built from (16-byte cp.async into shared memory,
// ldmatrix, mma.sync m16n8k16 bf16 and m16n8k32 s8), the sm_90a pieces
// of the wgmma kernels (the 128-byte-swizzled shared-memory descriptor, the
// wgmma fence, commit and wait, the async-proxy fence, the register pin),
// and the atomic ticket that elects the last block of a split-K strip.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// v rounded to T and back, as a float (a weight cast to x's dtype)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Packed int4 (ops/quant_matmul.py pack_int4): per k-tile of tile_k rows,
// byte j holds row j in its low nibble and row j + tile_k/2 in its high
// nibble, both signed. Column c (0..7) of an 8-byte word:
__device__ __forceinline__ uint32_t byte_word(uint2 w, int c) { return c < 4 ? w.x : w.y; }
__device__ __forceinline__ int nib_lo(uint2 w, int c) {
  return ((int)(byte_word(w, c) << (28 - 8 * (c & 3)))) >> 28;
}
__device__ __forceinline__ int nib_hi(uint2 w, int c) {
  return ((int)(byte_word(w, c) << (24 - 8 * (c & 3)))) >> 28;
}

// 16 bytes global -> registers through the non-coherent (read-only) path
__device__ __forceinline__ int4 ld_nc16(const void* p) {
  int4 r;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(__cvta_generic_to_global(p)));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously (L2 only); !valid fills zeros
// and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and receives row lane / 4, columns 2 (lane % 4) and + 1 of
// each (.trans: the transposed matrix's)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulation.
// Lane l = 4 g + c holds a: rows g, g + 8 x columns 2c, 2c + 1, 2c + 8,
// 2c + 9; b: rows 2c, 2c + 1 (b0) and 2c + 8, 2c + 9 (b1) of column g;
// d: rows g (d0, d1) and g + 8 (d2, d3), columns 2c and 2c + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col), s8 operands, exact s32 accumulation.
// Lane l = 4 g + c holds a: rows g (a0, a2) and g + 8 (a1, a3) x columns
// 4c .. 4c + 3 (a0, a1) and 16 + 4c .. 16 + 4c + 3 (a2, a3), a byte each;
// b: rows 4c .. 4c + 3 (b0) and 16 + 4c .. 16 + 4c + 3 (b1) of column g;
// d: rows g (d0, d1) and g + 8 (d2, d3), columns 2c and 2c + 1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// signed nibbles at bits 0-3 and 16-19 of t -> bf16x2 of the integers:
// bf16 bits 0x4300 | (u ^ 8) is 136 + q exactly
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t t) {
  const uint32_t biased = (t & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the pair's integers times their column's scale in f32, rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t q, float s) {
  return pack_bf16x2(__fmul_rn(__uint_as_float(q << 16), s),
                     __fmul_rn(__uint_as_float(q & 0xFFFF0000u), s));
}

// byte b (0..3) of a word whose sign bits were flipped (w ^ 0x80808080), as
// a float: b + 128 under the exponent of 2^23 (one PRMT), 2^23 + 128 off
__device__ __forceinline__ float i8_at(uint32_t flipped, int b) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | b)) - 8388736.f;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// The int8 bytes at bits 0-7 and 16-23 of t as an exact bf16x2: bf16 bits
// 0x4300 | (b & 0x7f) are 128 + (b & 0x7f), and 0x4300 | (b & 0x80) are 128,
// or 256 where b's sign bit is set, so their difference is b.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t t) {
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u, (t & 0x00800080u) | 0x43004300u);
}

// wgmma's shared-memory matrix descriptor over 128-byte-swizzled 8-row
// atoms (each row 128 bytes, an atom 1024 bytes, 1024-byte aligned).
// K-major (sw128_desc): the reduction runs along a row, the atoms of 8 rows
// (of M or N) sit 1024 bytes apart, the leading offset is unused (1).
// MN-major (sw128_desc_mn, a transposed operand): a row holds 64 elements
// of M or N and the reduction runs down the rows; lbo is the byte offset
// between 64-element chunks of M or N, sbo between 8-row groups of the
// reduction.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return sw128_desc_mn(saddr, 16, 1024);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed wgmma groups run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes to shared memory, visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pin the sums (or fragments) in registers at this point, so the compiler
// moves no access to them across the wgmma fence and waits.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// Whether this block is the last of the `arrivals` blocks of its strip to
// finish; if so every partial of the strip is visible to it. The last resets
// the ticket, so the words read zero at every launch and graph replay.
__device__ __forceinline__ bool last_of_strip(unsigned* ticket, unsigned arrivals, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1u) == arrivals - 1;
    if (last) atomicExch(ticket, 0u);  // every other block has taken its ticket
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

}  // namespace
