// The tensor-core decode stream of packed int4 weights with bf16 x, shared
// by #4 and #13 (quant_matmul_int4.cu: int4_decode_mma_body, whose design
// notes it follows) and by #6 (fused_mlp_int4.cu). A block's slice is a
// run of one k-tile's packed rows (blockIdx.y); a warp streams 128 columns
// of it in 8-row k-blocks. Lane (g, c) = (lane / 4, lane % 4) loads columns
// 16 g .. 16 g + 15 of packed rows j + c and j + c + 4 of each k-block with
// one 16-byte ld.global.nc each, and keeps the next k-block in flight while
// it uses the current one. nibbles_bf16x2 + scale_pair (common.cuh) make
// the mma.sync A fragments (f32(q) * scale rounded to bf16 on the quality
// route: one packing conversion a packed byte); x is the B operand, staged
// by the caller in shared memory in the k order below.
#pragma once

#include "common.cuh"

namespace {

// The staged x: bf16 index (kb * 8 + r) * 16 + 4 c' + 2 h + e holds x row
// r at packed row 8 kb + c' + 4 e of the low (h = 0) or high (h = 1)
// nibbles, so a lane's B fragment of a k-block is one 8-byte word pair.

constexpr int kMmaMaxXsBytes = 48 * 1024;       // 32 bytes of staged x a packed row

// whether the stream takes a bf16 call: 8-row k-blocks that stay inside one
// scale group and x's slice within its shared memory
// (ops/quant_matmul.py::int4_decode_tensor_cores)
inline bool mma_takes(int tile_k, int group, int k_slice) {
  return tile_k % 16 == 0 && (group == tile_k || group % 8 == 0) && k_slice % 8 == 0 &&
         32 * k_slice <= kMmaMaxXsBytes;
}

// the slices of k: each k-tile's packed rows cut into slices of k_slice
// (the last of a tile may be shorter)
inline int decode_slices(int k, int tile_k, int k_slice) {
  return k / tile_k * ((tile_k / 2 + k_slice - 1) / k_slice);
}

// Where a block's slice lies: tile `tile`, packed rows [pr0, pr0 + 8 kblocks)
// of it (the last slice of a tile may be shorter), low nibbles at x column klo
struct MmaSlice {
  int tile, pr0, kblocks, klo;
  __device__ MmaSlice(int tile_k, int k_slice) {
    const int half = tile_k / 2;
    const int per_tile = (half + k_slice - 1) / k_slice;
    tile = blockIdx.y / per_tile;
    pr0 = (blockIdx.y - tile * per_tile) * k_slice;
    kblocks = min(k_slice, half - pr0) / 8;
    klo = tile * tile_k + pr0;
  }
};

struct KBlock {
  int4 r0, r4;                                  // the lane's 16 bytes of rows j + c, j + c + 4
};

__device__ __forceinline__ void load_scales16(const float* p, float (&s)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z; s[4 * i + 3] = v.w;
  }
}

// k-block kb of a lane's stream; wp points at its 16 columns of packed row
// pr0 + c of the slice (zeros past the slice)
__device__ __forceinline__ void mma_load(KBlock& bt, const int8_t* wp, int n, int kb,
                                         int kblocks) {
  const bool in = kb < kblocks;
  const int8_t* p = wp + (size_t)(8 * kb) * n;
  bt.r0 = in ? ld_nc16(p) : make_int4(0, 0, 0, 0);
  bt.r4 = in ? ld_nc16(p + (size_t)4 * n) : make_int4(0, 0, 0, 0);
}

// A warp's sums over its slice: d[i] += the products of k-block after
// k-block, in order. xa is the staged x (m <= 8 rows), wp as mma_load's, gst
// the scales of the slice's tile at the lane's 16 columns (gscale + tile *
// (tile_k / group) * n + col), k-block 0 already loaded into A. Each next
// k-block is loaded into registers while the current one is used (1 KB a
// warp in flight; deeper pipelines measured slower, see
// quant_matmul_int4.cu and fused_mlp_int4.cu).
template <bool kOutScaled>
__device__ __forceinline__ void int4_mma_stream(const uint32_t* xa, int m, const int8_t* wp,
                                                const float* gst, int n, int half, int pr0,
                                                int group, int kblocks, KBlock& A,
                                                float (&d)[8][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  // the scales of the current low- and high-nibble groups (quality route),
  // and the slice row at which each group ends
  float slo[16], shi[16];
  int lo_end = 0, hi_end = 0;
  auto scales_for = [&](int j) {
    if (j >= lo_end) {
      const int gi = (pr0 + j) / group;
      load_scales16(gst + (size_t)gi * n, slo);
      lo_end = (gi + 1) * group - pr0;
    }
    if (j >= hi_end) {
      const int gi = (half + pr0 + j) / group;
      load_scales16(gst + (size_t)gi * n, shi);
      hi_end = (gi + 1) * group - half - pr0;
    }
  };

  auto use = [&](const KBlock& bt, int kb) {
    if (kb >= kblocks) return;
    if constexpr (!kOutScaled) scales_for(8 * kb);
    const uint2 xb = g < m ? reinterpret_cast<const uint2*>(xa)[(kb * 8 + g) * 4 + c]
                           : make_uint2(0u, 0u);
    const uint32_t w0[4] = {(uint32_t)bt.r0.x, (uint32_t)bt.r0.y, (uint32_t)bt.r0.z,
                            (uint32_t)bt.r0.w};
    const uint32_t w4[4] = {(uint32_t)bt.r4.x, (uint32_t)bt.r4.y, (uint32_t)bt.r4.z,
                            (uint32_t)bt.r4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // byte i (A row g) and byte 8 + i (A row g + 8) of rows j + c, j + c + 4
      const int sel = (i % 4) | ((4 + i % 4) << 8);
      const uint32_t t0 = __byte_perm(w0[i / 4], w4[i / 4], sel);
      const uint32_t t8 = __byte_perm(w0[2 + i / 4], w4[2 + i / 4], sel);
      uint32_t a[4] = {nibbles_bf16x2(t0), nibbles_bf16x2(t8), nibbles_bf16x2(t0 >> 4),
                       nibbles_bf16x2(t8 >> 4)};
      if constexpr (!kOutScaled) {
        a[0] = scale_pair(a[0], slo[i]);
        a[1] = scale_pair(a[1], slo[8 + i]);
        a[2] = scale_pair(a[2], shi[i]);
        a[3] = scale_pair(a[3], shi[8 + i]);
      }
      mma_bf16(d[i], a, xb.x, xb.y);
    }
  };
  KBlock B;
  for (int kb = 0; kb < kblocks; kb += 2) {
    mma_load(B, wp, n, kb + 1, kblocks);       // in flight while `A` is consumed
    use(A, kb);
    mma_load(A, wp, n, kb + 2, kblocks);       // in flight while `B` is consumed
    use(B, kb + 1);
  }
}

// Lane (g, c)'s sums as x rows 2c (v[0]) and 2c + 1 (v[1]) of its 16
// columns: d[i][0], d[i][1] are column i, d[i][2], d[i][3] column 8 + i
__device__ __forceinline__ void mma_rows(const float (&d)[8][4], float (&v)[2][16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[0][i] = d[i][0];
    v[1][i] = d[i][1];
    v[0][8 + i] = d[i][2];
    v[1][8 + i] = d[i][3];
  }
}

}  // namespace
