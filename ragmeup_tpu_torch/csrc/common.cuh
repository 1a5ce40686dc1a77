// Helpers shared by the kernels under csrc/: conversions between the
// activation types (float, bf16) and f32, the rounding of a dequantized
// weight to the activation type, and the signed nibbles of packed int4.
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

}  // namespace
