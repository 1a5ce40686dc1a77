// Grouped GEMM over packed-int4 stacked experts for Hopper (sm_90a):
//   out[i] = xp[i] @ dequant(w_p[texp[i / tm]] (k/2, n), gscale[...] (k/group, n))
// over rows sorted by expert and padded to tm-row tiles (ops/moe_matmul.py
// scatter_layout), w_p (E, k/2, n) int8, gscale (E, k/group, n) f32.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/moe_matmul.py::_grouped_kernel4,
// the batched-decode route past the per-slot gate: each unique routed
// expert's packed bytes cross device memory once per tile of its rows. At
// Mixtral's batched decode (16 rows over about 7 experts, group 128) one
// layer's gate, up and down read about 7 x 93.6 MB of packed experts and
// scales: about 0.20 ms at 3.35 TB/s, bound by those bytes.
//
// Design: rk_moe_grouped's (csrc/moe_matmul.cu) block per (tm-row tile,
// 128-column strip), walking all of k in steps of 32 packed rows. Packing is
// per pack_tile rows: byte j of a tile holds row j in its low nibble and row
// j + pack_tile/2 in its high nibble, so a step of 32 packed rows feeds 64
// rows of k, taken in shared memory as x's columns [klo, klo + 32) and
// [khi, khi + 32) against the low and the high nibbles: every packed byte is
// read once. A block reads its tile's expert and the used row count from
// device memory (no host sync); tiles from *used_rows on hold padding only
// and exit at once. The nibbles are unpacked on their way into shared memory
// and dequantized there as each route of the TPU kernel does:
//   - group < pack_tile: each weight is f32(q) * f32(scale), rounded to x's
//     dtype (the plain version's arithmetic), and one f32 accumulator runs
//     over all of k;
//   - group == pack_tile (output-scaled): the weights are the integers
//     themselves, one accumulator sums a packing tile, and at the tile's end
//     it is multiplied by the tile's scale and added to the running f32 sum,
//     in tile order (the scale never enters the bf16 weights).
// bf16 activations multiply on the tensor cores (WMMA 16x16x16, f32
// accumulation, 8 warps over a 16 x 128 tile, the next step's loads in
// flight through registers while the current one multiplies); f32
// activations take f32 FMAs (8-row tiles), since a tensor-core product
// would round them. No cp.async/TMA or wgmma yet: a later PR's work.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBN = 128;      // columns per block
constexpr int kStepP = 32;    // packed rows per k step (64 rows of k)
constexpr int kStepK = 2 * kStepP;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;   // bf16 kernel
constexpr int kF32Threads = kBN;        // f32 kernel: one column a thread
constexpr int kPad = 8;                 // bf16 row padding of the shared tiles

// Where k step s lies: packed rows [p0, p0 + 32) of packing tile t; x
// columns [klo, klo + 32) take the low nibbles, [khi, khi + 32) the high.
struct Step {
  int t, p0, klo, khi;
  __device__ Step(int s, int pack_tile) {
    const int half = pack_tile / 2;
    const int per_tile = half / kStepP;
    t = s / per_tile;
    const int o = (s - t * per_tile) * kStepP;
    p0 = t * half + o;
    klo = t * pack_tile + o;
    khi = klo + half;
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The 16 signed nibbles of one half (hi = false: low nibbles) of 16 packed
// bytes, each dequantized (kScaled: times its column's scale, rounded to T)
template <typename T, bool kScaled>
__device__ __forceinline__ void unpack16(const uint4& v, bool hi, const float* s,
                                         float (&f)[16]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint2 w2 = make_uint2(words[q], 0u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float iv = (float)(hi ? nib_hi(w2, c) : nib_lo(w2, c));
      f[4 * q + c] = kScaled ? round_to<T>(__fmul_rn(iv, __ldg(s + 4 * q + c))) : iv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 activations: WMMA, 16-row tiles
// ---------------------------------------------------------------------------

template <bool kOutScaled>
__global__ void __launch_bounds__(kThreads) rk_moe_grouped_int4_wmma_kernel(
    const __nv_bfloat16* __restrict__ xp, const int8_t* __restrict__ w_p,
    const float* __restrict__ gs, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n, int pack_tile, int group,
    __nv_bfloat16* __restrict__ out) {
  constexpr int BM = 16;
  constexpr int LDX = kStepK + kPad;
  constexpr int LDW = kBN + kPad;
  __shared__ __align__(32) __nv_bfloat16 xs[BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 ws[kStepK * LDW];
  __shared__ __align__(32) float stage[kWarps][16 * 16];

  const int m0 = blockIdx.y * BM;
  if (m0 >= *used_rows) return;
  const int n0 = blockIdx.x * kBN;
  const size_t e = (size_t)texp[blockIdx.y];
  const int8_t* wbase = w_p + e * (size_t)(k / 2) * n + n0;
  const float* gbase = gs + e * (size_t)(k / group) * n + n0;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int steps = k / kStepK;
  const int per_tile = pack_tile / kStepK;

  // loads: x, thread i < 128: row i / 8, 16-byte segment i % 8 (0-3 from
  // klo, 4-7 from khi); weights, every thread: packed row tid / 8, 16
  // columns from (tid % 8) * 16
  const int xr = tid / 8, xseg = tid % 8;
  const int wr = tid / 8, wc = (tid % 8) * 16;
  uint4 xv = make_uint4(0u, 0u, 0u, 0u), wv;
  auto load = [&](int s) {
    const Step st(s, pack_tile);
    if (tid < BM * 8) {
      const int col = (xseg < 4 ? st.klo + xseg * 8 : st.khi + (xseg - 4) * 8);
      xv = *reinterpret_cast<const uint4*>(xp + (size_t)(m0 + xr) * k + col);
    }
    wv = __ldg(reinterpret_cast<const uint4*>(wbase + (size_t)(st.p0 + wr) * n + wc));
  };
  auto store = [&](int s) {
    const Step st(s, pack_tile);
    if (tid < BM * 8) *reinterpret_cast<uint4*>(&xs[xr * LDX + xseg * 8]) = xv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f[16];
      const float* srow = gbase + (size_t)((h ? st.khi : st.klo) + wr) / group * n + wc;
      unpack16<__nv_bfloat16, !kOutScaled>(wv, h == 1, srow, f);
      uint4* dst = reinterpret_cast<uint4*>(&ws[(h * kStepP + wr) * LDW + wc]);
      dst[0] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                          pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
      dst[1] = make_uint4(pack_bf16x2(f[8], f[9]), pack_bf16x2(f[10], f[11]),
                          pack_bf16x2(f[12], f[13]), pack_bf16x2(f[14], f[15]));
    }
  };

  // each warp owns output columns [warp * 16, warp * 16 + 16) of the strip;
  // each lane ends up holding 8 adjacent outputs of one row of them
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
  float* stg = stage[warp];
  float total[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) load(s + 1);
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, &xs[kk], LDX);
      wmma::load_matrix_sync(b, &ws[kk * LDW + warp * 16], LDW);
      wmma::mma_sync(acc, a, b, acc);
    }
    if (kOutScaled && (s + 1) % per_tile == 0) {
      // the packing tile's sum times its scale, added in tile order
      wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const float* sc = gbase + (size_t)(s / per_tile) * n + warp * 16 + c0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        total[q] = __fadd_rn(total[q], __fmul_rn(stg[r * 16 + c0 + q], __ldg(sc + q)));
      __syncwarp();
      wmma::fill_fragment(acc, 0.f);
    }
    __syncthreads();
    if (more) {
      store(s + 1);
      __syncthreads();
    }
  }
  if (!kOutScaled) {
    wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q) total[q] = stg[r * 16 + c0 + q];
  }
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) packed[q] = pack_bf16x2(total[2 * q], total[2 * q + 1]);
  *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n + n0 + warp * 16 + c0) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// ---------------------------------------------------------------------------
// f32 activations: f32 FMAs, 8-row tiles, one column of the strip a thread
// ---------------------------------------------------------------------------

template <bool kOutScaled>
__global__ void __launch_bounds__(kF32Threads) rk_moe_grouped_int4_f32_kernel(
    const float* __restrict__ xp, const int8_t* __restrict__ w_p,
    const float* __restrict__ gs, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n, int pack_tile, int group,
    float* __restrict__ out) {
  constexpr int BM = 8;
  __shared__ float xs[BM][kStepK];
  __shared__ float ws[kStepK][kBN];
  const int m0 = blockIdx.y * BM;
  if (m0 >= *used_rows) return;
  const int n0 = blockIdx.x * kBN;
  const size_t e = (size_t)texp[blockIdx.y];
  const int8_t* wbase = w_p + e * (size_t)(k / 2) * n + n0;
  const float* gbase = gs + e * (size_t)(k / group) * n + n0;
  const int tid = threadIdx.x;
  const int steps = k / kStepK;
  const int per_tile = pack_tile / kStepK;
  float acc[BM], total[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = total[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const Step st(s, pack_tile);
    for (int i = tid; i < BM * kStepK; i += kF32Threads) {
      const int row = i / kStepK, j = i % kStepK;
      xs[row][j] = xp[(size_t)(m0 + row) * k + (j < kStepP ? st.klo + j : st.khi + j - kStepP)];
    }
    // 32 packed rows x 128 bytes: 256 16-byte loads, two a thread
    for (int i = tid; i < kStepP * (kBN / 16); i += kF32Threads) {
      const int pr = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wbase + (size_t)(st.p0 + pr) * n + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float f[16];
        const float* srow = gbase + (size_t)((h ? st.khi : st.klo) + pr) / group * n + c;
        unpack16<float, !kOutScaled>(v, h == 1, srow, f);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[h * kStepP + pr][c + q] = f[q];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStepK; ++kk) {
      const float wvv = ws[kk][tid];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = fmaf(xs[i][kk], wvv, acc[i]);
    }
    __syncthreads();
    if (kOutScaled && (s + 1) % per_tile == 0) {
      const float sc = __ldg(gbase + (size_t)(s / per_tile) * n + tid);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        total[i] = __fadd_rn(total[i], __fmul_rn(acc[i], sc));
        acc[i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BM; ++i)
    out[(size_t)(m0 + i) * n + n0 + tid] = kOutScaled ? total[i] : acc[i];
}

}  // namespace

extern "C" {

// xp (mp, k) in dtype (0 = float32, 1 = bfloat16), rows padded to tm-row
// tiles (tm = 16 for bf16, 8 for float32); w_p (E, k/2, n) packed int8 per
// pack_tile rows; gscale (E, k/group, n) f32; texp (mp / tm,) int32 expert
// per tile; used (1,) int32, the rows the groups fill (tiles from there on
// are skipped, their rows left unwritten); out (mp, n) in x's dtype.
// pack_tile % 64 == 0, k % pack_tile == 0, group divides pack_tile,
// n % 128 == 0. Returns a cudaError_t.
int rk_moe_grouped_int4(const void* xp, const int8_t* w_p, const float* gscale,
                        const int* texp, const int* used, int mp, int k, int n,
                        int pack_tile, int group, int dtype, void* out,
                        void* stream) {
  const int tm = dtype == 1 ? 16 : 8;
  if (pack_tile < kStepK || pack_tile % kStepK || k % pack_tile || group < 1 ||
      pack_tile % group || n % kBN || mp % tm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / kBN, mp / tm);
  const bool out_scaled = group == pack_tile;
  if (dtype == 1) {
    const auto* x = static_cast<const __nv_bfloat16*>(xp);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (out_scaled)
      rk_moe_grouped_int4_wmma_kernel<true><<<grid, kThreads, 0, s>>>(
          x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
    else
      rk_moe_grouped_int4_wmma_kernel<false><<<grid, kThreads, 0, s>>>(
          x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
  } else {
    const auto* x = static_cast<const float*>(xp);
    auto* o = static_cast<float*>(out);
    if (out_scaled)
      rk_moe_grouped_int4_f32_kernel<true><<<grid, kF32Threads, 0, s>>>(
          x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
    else
      rk_moe_grouped_int4_f32_kernel<false><<<grid, kF32Threads, 0, s>>>(
          x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
