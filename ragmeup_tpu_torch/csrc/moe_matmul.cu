// Sparse-MoE expert matmuls for Hopper (sm_90a), over stacked experts
// w (E, k, n): int8 with per-expert per-output-channel scales (E, n), or
// bf16 / f32 with no scale. Each weight is cast to x's dtype before the
// product, products and sums are f32, the scale multiplies the sum, and the
// result rounds once to x's dtype (0 = float32, 1 = bfloat16).
//
// rk_moe_gather replaces the Pallas kernel
// ragmeup_tpu/ops/moe_matmul.py::_kernel: out[s] = x[s] @ w[ids[s]] for at
// most 64 slots. At decode it is bound by reading the routed experts'
// bytes once (Mixtral: 2 slots x 3 projections, 352 MB of int8 a layer,
// 0.105 ms at 3.35 TB/s). Design: quant_matmul.cu's deterministic split-K
// stream with one more grid axis for the slot. A block reads its slot's
// expert id from device memory (the TPU kernel's scalar prefetch) and
// offsets the weights by it; each thread owns 4 adjacent columns and
// walks its k-slice with one vector load a row (a warp reads 128
// contiguous weights), the slice of x in shared memory. Slices write f32
// partials; a second kernel sums them in a fixed order and applies the
// scale, so a greedy decode repeats bit for bit.
//
// rk_moe_grouped replaces ragmeup_tpu/ops/moe_matmul.py::_grouped_kernel:
// the grouped GEMM over rows sorted by expert and padded to tm-row tiles,
// tile i reading expert texp[i]. One block computes one (tm-row tile,
// 128-column strip) over all of k, in 64-deep steps through shared memory;
// the weights are cast to x's dtype as they land there, and the int8 scale
// is applied in the epilogue. bf16 activations multiply on the tensor cores
// (WMMA 16x16x16, f32 accumulation, 8 warps, the next step's 16-byte loads
// in flight while the current step multiplies); f32 activations take f32
// FMAs, since a tensor-core product would round them. Tiles from *used_rows
// on hold padding only and exit at once: their rows are never read back.
// Which kernel serves which route (ops/moe_matmul.py stack_kernel_takes):
//   - the dedup route (#11, batched decode: 16 slots, at most 8 unique
//     experts, tm = 16): the WMMA kernel here, streaming each routed
//     expert's weights once per tile, up to 1.41 GB a Mixtral layer (0.42
//     ms at 3.35 TB/s);
//   - the full-stack route (#12, prefill under moe_grouped="on", every
//     expert routed, tm = 128) with bf16 rows and int8 or bf16 experts:
//     csrc/moe_stack.cu's wgmma kernel, which also skips the padding rows;
//   - f32 rows or f32 experts on either route, and the full-stack route at
//     other tiles: the kernels here.
// No asynchronous copies (cp.async/TMA) and no wgmma here.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 512
constexpr int kMaxSlice = 256;

constexpr int kGroupedBN = 128;  // columns per block
constexpr int kGroupedBK = 64;   // k per step
constexpr int kGroupedWarps = 8;
constexpr int kGroupedThreads = 32 * kGroupedWarps;  // bf16 route
constexpr int kPad = 8;          // bf16 row padding of the shared tiles

// Four adjacent weights w[0..3] (16-byte-aligned rows, 4-aligned column)
// in one vector load, cast to T. int8 and bf16 values are exact in bf16.
template <typename T>
__device__ __forceinline__ void load_w4(const int8_t* p, float (&f)[4]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
template <typename T>
__device__ __forceinline__ void load_w4(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = round_to<T>(v.x); f[1] = round_to<T>(v.y);
  f[2] = round_to<T>(v.z); f[3] = round_to<T>(v.w);
}

// ---------------------------------------------------------------------------
// gather: grid (column blocks, k slices, slots)
// ---------------------------------------------------------------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) rk_moe_gather_partial_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const int* __restrict__ ids,
    int slots, int k, int n, int k_slice, float* __restrict__ partial) {
  __shared__ float xs[kMaxSlice];
  const int s = blockIdx.z;
  const int k0 = blockIdx.y * k_slice;
  for (int j = threadIdx.x; j < k_slice; j += kThreads)
    xs[j] = to_f32(x[(size_t)s * k + k0 + j]);
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (col >= n) return;
  const size_t e = (size_t)ids[s];
  const W* wp = w + (e * k + k0) * n + col;
  float acc[kColsPerThread] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int j = 0; j < k_slice; ++j) {
    float wv[kColsPerThread];
    load_w4<T>(wp + (size_t)j * n, wv);
    const float xv = xs[j];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[c] = fmaf(xv, wv[c], acc[c]);
  }
  *reinterpret_cast<float4*>(partial + ((size_t)blockIdx.y * slots + s) * n + col) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <typename T>
__global__ void rk_moe_gather_reduce_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ ids, int slots,
                                            int n, int splits, T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= slots * n) return;
  float v = 0.f;
  for (int p = 0; p < splits; ++p) v += partial[(size_t)p * slots * n + idx];
  if (scale != nullptr) v *= scale[(size_t)ids[idx / n] * n + idx % n];
  out[idx] = from_f32<T>(v);
}

template <typename T, typename W>
int launch_gather(const void* x, const void* w, const float* scale, const int* ids,
                  int slots, int k, int n, int k_slice, float* partial, void* out,
                  cudaStream_t stream) {
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, k / k_slice, slots);
  rk_moe_gather_partial_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), ids, slots, k, n, k_slice,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = slots * n;
  rk_moe_gather_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      partial, scale, ids, slots, n, k / k_slice, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_gather(int wtype, const void* x, const void* w, const float* scale,
                    const int* ids, int slots, int k, int n, int k_slice,
                    float* partial, void* out, cudaStream_t stream) {
  if (wtype == 2)
    return launch_gather<T, int8_t>(x, w, scale, ids, slots, k, n, k_slice, partial,
                                    out, stream);
  if (wtype == 1)
    return launch_gather<T, __nv_bfloat16>(x, w, scale, ids, slots, k, n, k_slice,
                                           partial, out, stream);
  return launch_gather<T, float>(x, w, scale, ids, slots, k, n, k_slice, partial,
                                 out, stream);
}

// ---------------------------------------------------------------------------
// grouped: one block per (tm-row tile, 128-column strip)
// ---------------------------------------------------------------------------

// bf16 activations: 8 warps over the BM x 128 tile (2 x 4 warps from 32
// rows up, 1 x 8 at 16), WMMA 16x16x16 with f32 accumulators. The k loop
// is pipelined through registers: each thread issues its 16-byte loads
// of the next 64-deep x and weight tiles before the tensor cores work on
// the current ones, then casts the weights to bf16 on their way into
// shared memory.
template <int BM>
struct WarpLayout {
  static constexpr int kWM = BM >= 32 ? 2 : 1;          // warps along m
  static constexpr int kWN = kGroupedWarps / kWM;       // warps along n
  static constexpr int kMF = BM / kWM / 16;             // fragments a warp, m
  static constexpr int kNF = kGroupedBN / kWN / 16;     // fragments a warp, n
};

// 16 bytes of weights → bf16 in shared memory at dst (8, 16 or 4 values)
__device__ __forceinline__ void store_bf16(const uint4& v, const int8_t*,
                                           __nv_bfloat16* dst) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t packed[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t wd = words[q];
    packed[2 * q] = pack_bf16x2((float)((int)(wd << 24) >> 24),
                                (float)((int)(wd << 16) >> 24));
    packed[2 * q + 1] = pack_bf16x2((float)((int)(wd << 8) >> 24),
                                    (float)((int)wd >> 24));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}
__device__ __forceinline__ void store_bf16(const uint4& v, const __nv_bfloat16*,
                                           __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store_bf16(const uint4& v, const float*,
                                           __nv_bfloat16* dst) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16x2(__uint_as_float(v.x), __uint_as_float(v.y)),
                 pack_bf16x2(__uint_as_float(v.z), __uint_as_float(v.w)));
}

template <typename W, int BM>
__global__ void __launch_bounds__(kGroupedThreads, BM <= 32 ? 4 : 2)
rk_moe_grouped_wmma_kernel(
    const __nv_bfloat16* __restrict__ xp, const W* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n,
    __nv_bfloat16* __restrict__ out) {
  using L = WarpLayout<BM>;
  constexpr int LDX = kGroupedBK + kPad;
  constexpr int LDW = kGroupedBN + kPad;
  constexpr int kXLoads = BM * kGroupedBK / 8;                     // 16 B each
  constexpr int kXPer = (kXLoads + kGroupedThreads - 1) / kGroupedThreads;
  constexpr int kWPerLoad = 16 / (int)sizeof(W);                   // weights a load
  constexpr int kWLoads = kGroupedBK * kGroupedBN / kWPerLoad;
  constexpr int kWPer = kWLoads / kGroupedThreads;
  __shared__ __align__(32) __nv_bfloat16 xs[BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 ws[kGroupedBK * LDW];
  __shared__ __align__(32) float stage[kGroupedWarps][16 * 16];

  const int mt = blockIdx.y;
  const int nt = blockIdx.x;
  const int m0 = mt * BM;
  if (m0 >= *used_rows) return;
  const int n0 = nt * kGroupedBN;
  const size_t e = (size_t)texp[mt];
  const W* wbase = w + e * (size_t)k * n + n0;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / L::kWN;
  const int wn = warp % L::kWN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[L::kMF][L::kNF];
#pragma unroll
  for (int i = 0; i < L::kMF; ++i)
#pragma unroll
    for (int j = 0; j < L::kNF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 xr[kXPer];
  uint4 wr[kWPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int i = tid + q * kGroupedThreads;
      if (i < kXLoads)
        xr[q] = *reinterpret_cast<const uint4*>(
            xp + (size_t)(m0 + i / (kGroupedBK / 8)) * k + k0 + (i % (kGroupedBK / 8)) * 8);
    }
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int i = tid + q * kGroupedThreads;
      const int r = i / (kGroupedBN / kWPerLoad);
      const int c = (i % (kGroupedBN / kWPerLoad)) * kWPerLoad;
      wr[q] = __ldg(reinterpret_cast<const uint4*>(wbase + (size_t)(k0 + r) * n + c));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int i = tid + q * kGroupedThreads;
      if (i < kXLoads)
        *reinterpret_cast<uint4*>(
            &xs[(i / (kGroupedBK / 8)) * LDX + (i % (kGroupedBK / 8)) * 8]) = xr[q];
    }
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int i = tid + q * kGroupedThreads;
      const int r = i / (kGroupedBN / kWPerLoad);
      const int c = (i % (kGroupedBN / kWPerLoad)) * kWPerLoad;
      store_bf16(wr[q], static_cast<const W*>(nullptr), &ws[r * LDW + c]);
    }
  };

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < k; k0 += kGroupedBK) {
    const bool more = k0 + kGroupedBK < k;
    if (more) load(k0 + kGroupedBK);
#pragma unroll
    for (int kk = 0; kk < kGroupedBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          b[L::kNF];
#pragma unroll
      for (int j = 0; j < L::kNF; ++j)
        wmma::load_matrix_sync(b[j], &ws[kk * LDW + (wn * L::kNF + j) * 16], LDW);
#pragma unroll
      for (int i = 0; i < L::kMF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[(wm * L::kMF + i) * 16 * LDX + kk], LDX);
#pragma unroll
        for (int j = 0; j < L::kNF; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue: through a per-warp 16x16 staging tile; each lane scales and
  // rounds 8 adjacent outputs of one row and stores them as 16 bytes
  const float* srow = scale != nullptr ? scale + e * n : nullptr;
  float* st = stage[warp];
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < L::kMF; ++i) {
#pragma unroll
    for (int j = 0; j < L::kNF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + (wm * L::kMF + i) * 16 + r;
      const int col = n0 + (wn * L::kNF + j) * 16 + c0;
      uint32_t packed[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v0 = st[r * 16 + c0 + 2 * q];
        float v1 = st[r * 16 + c0 + 2 * q + 1];
        if (srow != nullptr) {
          v0 *= srow[col + 2 * q];
          v1 *= srow[col + 2 * q + 1];
        }
        packed[q] = pack_bf16x2(v0, v1);
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * n + col) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      __syncwarp();
    }
  }
}

// f32 activations: f32 FMAs, one column of the strip a thread, all BM rows
// in registers; the row values are broadcast from shared memory.
template <typename W, int BM>
__global__ void __launch_bounds__(kThreads) rk_moe_grouped_f32_kernel(
    const float* __restrict__ xp, const W* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n,
    float* __restrict__ out) {
  constexpr int BK = 32;
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][kGroupedBN];
  const int mt = blockIdx.y;
  const int nt = blockIdx.x;
  const int m0 = mt * BM;
  if (m0 >= *used_rows) return;
  const int n0 = nt * kGroupedBN;
  const size_t e = (size_t)texp[mt];
  const W* wbase = w + e * (size_t)k * n + n0;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads)
      xs[i / BK][i % BK] = xp[(size_t)(m0 + i / BK) * k + k0 + i % BK];
    for (int i = threadIdx.x; i < BK * (kGroupedBN / 4); i += kThreads) {
      const int r = i / (kGroupedBN / 4);
      const int c = (i % (kGroupedBN / 4)) * 4;
      float f[4];
      load_w4<float>(wbase + (size_t)(k0 + r) * n + c, f);
#pragma unroll
      for (int q = 0; q < 4; ++q) ws[r][c + q] = f[q];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float wv = ws[kk][threadIdx.x];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = fmaf(xs[r][kk], wv, acc[r]);
    }
    __syncthreads();
  }
  const int col = n0 + threadIdx.x;
  const float s = scale != nullptr ? scale[e * n + col] : 1.f;
#pragma unroll
  for (int r = 0; r < BM; ++r)
    out[(size_t)(m0 + r) * n + col] = scale != nullptr ? acc[r] * s : acc[r];
}

template <typename W, int BM>
int launch_grouped(int dtype, const void* xp, const void* w, const float* scale,
                   const int* texp, const int* used, int mp, int k, int n,
                   void* out, cudaStream_t stream) {
  const dim3 grid(n / kGroupedBN, mp / BM);
  if (dtype == 1) {
    if constexpr (BM % 16 == 0) {
      rk_moe_grouped_wmma_kernel<W, BM><<<grid, kGroupedThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(xp), static_cast<const W*>(w), scale,
          texp, used, k, n, static_cast<__nv_bfloat16*>(out));
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    rk_moe_grouped_f32_kernel<W, BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(xp), static_cast<const W*>(w), scale, texp, used,
        k, n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch_grouped_tm(int tm, int dtype, const void* xp, const void* w,
                        const float* scale, const int* texp, const int* used, int mp,
                        int k, int n, void* out, cudaStream_t stream) {
  switch (tm) {
    case 8:
      return launch_grouped<W, 8>(dtype, xp, w, scale, texp, used, mp, k, n,
                                  out, stream);
    case 16:
      return launch_grouped<W, 16>(dtype, xp, w, scale, texp, used, mp, k, n,
                                   out, stream);
    case 32:
      return launch_grouped<W, 32>(dtype, xp, w, scale, texp, used, mp, k, n,
                                   out, stream);
    case 64:
      return launch_grouped<W, 64>(dtype, xp, w, scale, texp, used, mp, k, n,
                                   out, stream);
    case 128:
      return launch_grouped<W, 128>(dtype, xp, w, scale, texp, used, mp, k, n,
                                    out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (slots, k) in dtype, w (E, k, n) of wtype (0 = float32, 1 = bfloat16,
// 2 = int8), scale (E, n) f32 or null, ids (slots,) int32, out (slots, n)
// in x's dtype. n % 4 == 0, k % k_slice == 0, k_slice <= 256; partial holds
// (k / k_slice) * slots * n floats. Returns a cudaError_t.
int rk_moe_gather(const void* x, const void* w, const float* scale, const int* ids,
                  int slots, int k, int n, int k_slice, int dtype, int wtype,
                  float* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_gather<__nv_bfloat16>(wtype, x, w, scale, ids, slots, k, n,
                                          k_slice, partial, out, s);
  return dispatch_gather<float>(wtype, x, w, scale, ids, slots, k, n, k_slice,
                                partial, out, s);
}

// xp (mp, k) in dtype, rows padded to tm-row tiles; w (E, k, n) of wtype,
// scale (E, n) f32 or null; texp (mp / tm,) int32 expert per tile; used
// (1,) int32, the rows the groups fill (tiles from there on are skipped);
// out (mp, n) in x's dtype, rows of skipped tiles left unwritten.
// tm in {8, 16, 32, 64, 128} (bf16: >= 16), k % 64 == 0, n % 128 == 0.
int rk_moe_grouped(const void* xp, const void* w, const float* scale,
                   const int* texp, const int* used, int mp, int k, int n, int tm,
                   int dtype, int wtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kGroupedBK || n % kGroupedBN || mp % tm) return (int)cudaErrorInvalidValue;
  if (wtype == 2)
    return dispatch_grouped_tm<int8_t>(tm, dtype, xp, w, scale, texp, used, mp, k, n,
                                       out, s);
  if (wtype == 1)
    return dispatch_grouped_tm<__nv_bfloat16>(tm, dtype, xp, w, scale, texp, used,
                                              mp, k, n, out, s);
  return dispatch_grouped_tm<float>(tm, dtype, xp, w, scale, texp, used, mp, k, n,
                                    out, s);
}

}  // extern "C"
