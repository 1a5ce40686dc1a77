// Helpers shared by the kernels under csrc/: conversions between the
// activation types (float, bf16) and f32, the rounding of a dequantized
// weight to the activation type, int8 weights as exact f32 or bf16 values
// without the conversion unit, the signed nibbles of packed int4 (one at
// a time, or two at once as exact bf16 integers without the conversion
// unit), the 16-byte read-only weight load, the sm_80+ instructions the
// tensor-core kernels are built from (16-byte cp.async into shared memory,
// ldmatrix, mma.sync m16n8k16 bf16 and m16n8k32 s8), the sm_90a pieces
// of the wgmma kernels (the 128-byte-swizzled shared-memory descriptor, the
// wgmma fence, commit and wait, the async-proxy fence, the register pin,
// named barriers, setmaxnreg, mbarriers, TMA tensor copies and their
// descriptors over rows of 256 bf16, the swizzled panel layout, the
// m64n64k16 and m64n256k16 products of the attention kernels), and the
// atomic ticket that elects the last block of a split-K strip.
#pragma once

#include <cuda.h>
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

// Named barrier `id` over `count` threads: wait for it, or only arrive.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A warpgroup's registers a thread, moved between warpgroups of one block.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// mbarriers in shared memory. A "full" barrier completes when its data has
// landed: q's cp.async copies arrive on it as they complete (noinc: the
// count is the producer's threads); a K or V tile's TMA copies count their
// bytes against the one arrival that announced them (expect_tx). Each
// consumer warp arrives on an "empty" barrier once its wgmmas have read the
// stage. Waits spin on the phase parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar)) : "memory");
}
// Byte offset of 16-byte chunk c (0..31) of row r in a tile of `rows` rows of
// 256 bf16: four panels of 64 columns, each row 128 bytes, 128-byte swizzle.
__device__ __forceinline__ int panel_off(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// d (64 x 64 f32: lane 4g + c of warp w of the warpgroup holds rows 16w + g,
// + 8 x columns 8j + 2c, + 1 as d[4j .. 4j + 3]) += a (64 x 16, K-major at
// da) * b (16 x 64, K-major at db): both operands from shared memory
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256 f32, the layout of wgmma_ss_64x64 over 32 column groups) +=
// a (64 x 16 bf16 in registers, mma.sync's A layout a warp) * b (16 x 256,
// MN-major at db: the operand transposed)
__device__ __forceinline__ void wgmma_rs_64x256_t(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda): the TMA descriptors.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (planes, rows, 256) bf16 with planes plane_rows rows apart: boxes of
// box_rows rows x 64 columns (one 128-byte-swizzled panel); rows at or
// past `rows`, and negative ones, read as zeros
cudaError_t bf16_panel_map(CUtensorMap* map, const void* base, int planes, long long rows,
                           long long plane_rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {256, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {256 * 2, (cuuint64_t)plane_rows * 256 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
