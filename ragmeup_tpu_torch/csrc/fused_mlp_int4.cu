// Fused transformer MLP over packed-int4 weights for Hopper (sm_90a):
//   out (m, h) = x + down(silu(gate(rms(x))) * up(rms(x)))   with m <= 8,
// gate/up w_p (h/2, I) with gscale (h/group_h, I), down w_p (I/2, h) with
// gscale (I/group_i, h); packing per k-tile as in ops/quant_matmul.py.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/quant_matmul.py::_mlp_kernel4.
// At decode the MLP is bound by reading its packed weights once: at the
// Llama-3.1-8B shape (h 4096, I 14336, group 128) 88 MB of nibbles and
// 5.5 MB of scales, 0.028 ms at 3.35 TB/s (gate/up 62.4 MB, down 31.2 MB).
// The TPU kernel carries the gate, up and output sums across one sequential
// grid; Hopper blocks carry nothing between them. Rounding is the TPU
// kernel's: rms(x) * nw in f32 rounded to x's dtype; each weight f32(q) *
// scale rounded to x's dtype (at every group size), products summed in
// f32; silu(g) * u rounded to x's dtype; x + down in f32, rounded once.
//
// bf16 x (the tensor-core route, rk_mlp4_gate_up_mma_kernel and
// rk_mlp4_down_mma_kernel): both products are #4's decode problem with a
// prologue and an epilogue, so both run #4's tensor-core stream
// (int4_mma_stream, int4_decode_mma.cuh) unchanged:
//
//   * Conversions. The weights are the mma.sync m16n8k16 A operand, made by
//     nibbles_bf16x2 (no conversion) and scale_pair (one F2FP a packed
//     byte, two weights); the normalised x is the B operand. m <= 8 fills
//     the mma's 8 columns, so m = 8 costs the weight stream what m = 1 does.
//     (The scalar route spends an I2F and an F2F a weight: 4 a packed byte.)
//   * Bytes in flight. A warp streams 128 columns of a slice with 16-byte
//     loads, one 8-row k-block (1 KB a warp) in use and the next in flight:
//     16 warps an SM at 128 registers a thread. Gate/up blocks are 8 warps
//     (warps 0-3 the gate's 512-column strip, 4-7 up's same strip, so
//     silu(g) * u needs no round trip of g and u), down blocks #4's 4.
//     Measured on the card, neither L2 prefetches of later k-blocks nor a
//     cp.async ring of 2-8 k-blocks a warp made the stream faster (the ring
//     was slower): it waits on its ~270 instructions a k-block and lane.
//   * Slices (ops/quant_matmul.py::fused_mlp_int4_plan): each phase in one
//     wave of resident blocks, as many slices of a k-tile's packed rows as
//     fill the card once; at the 8B shape on 132 SMs gate/up 28 strips x 8
//     slices of 256 rows (224 blocks, 2 can reside an SM), down 8 x 56 of
//     128 (448 blocks, 4 an SM). Smaller slices, a second wave, were slower.
//   * Prologue. Each gate/up block reads its slice's x values and norm
//     weights, then each row's share for 1/rms (16-byte loads, a
//     fixed-order reduction, one __syncthreads pair for all rows) in one
//     round trip while its first k-block is in flight, and stages rms(x) *
//     nw as bf16 in the stream's k order (two 16-byte stores a k-block and
//     row). Down stages act, bf16 already, the same way. (Normalising x
//     once in a launch of its own was no faster.)
//   * Sums, deterministic (no float atomics: a decode repeats bit for bit).
//     Each block writes its slice's f32 partial; the slices are added in
//     slice order, then the epilogue: silu(g) * u for gate/up, + x for
//     down. Route 1 (m = 1): an atomic ticket a column strip elects the
//     strip's last block to finish, which sums the strip and resets its
//     ticket (the words read zero at every launch and graph replay): two
//     launches a call. Route 2 (m >= 2): a reduce launch after each phase,
//     its sums spread over the card, four launches: at m = 8 the last block
//     of a strip would read 8x the partials alone. (Down launched with
//     programmatic dependent launch, to overlap gate/up's tail, was no
//     faster.)

#include "int4_decode_mma.cuh"

namespace {


// ---------------------------------------------------------------------------
// The scalar route: f32 x, and bf16 shapes the tensor-core route refuses
// ---------------------------------------------------------------------------
//
// Two launches. rk_mlp4_gate_up_kernel: a block owns 64 columns of I, takes
// the RMS of each row of x and, in 16 groups of 16 threads, sums a
// sixteenth of h for 4 columns a thread, x normalised on the fly; the
// groups are added in group order and act = silu(g) * u is written to a
// scratch (m, I). rk_mlp4_down_kernel: a block owns 32 columns of h; 32
// groups of 8 threads each sum a thirty-second of I over act, added in group
// order, plus the residual. Every weight is f32(q) * f32(scale) rounded to
// x's dtype; products are f32 FMAs.

constexpr int kThreads = 256;
constexpr int kCols = 4;                                  // columns per thread
constexpr int kUpCols = 64;                               // gate/up: columns a block
constexpr int kUpGroups = kThreads / (kUpCols / kCols);   // 16 k-groups
constexpr int kDnCols = 32;                               // down: columns a block
constexpr int kDnGroups = kThreads / (kDnCols / kCols);   // 32 k-groups

// Where packed row p lies: x columns klo (low nibble) and khi (high nibble)
__device__ __forceinline__ void packed_row(int p, int tile_k, int& klo, int& khi) {
  const int half = tile_k / 2;
  const int t = p / half;
  klo = t * tile_k + (p - t * half);
  khi = klo + half;
}

// 4 weights of one nibble half of a 4-byte word, dequantized and rounded to T
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t word, bool hi, const float (&s)[kCols],
                                         float (&f)[kCols]) {
  const uint2 w2 = make_uint2(word, 0u);
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    f[c] = round_to<T>(__fmul_rn((float)(hi ? nib_hi(w2, c) : nib_lo(w2, c)), s[c]));
}

__device__ __forceinline__ void load_scales(const float* gs, int g, int n, int col,
                                            float (&s)[kCols]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(gs + (size_t)g * n + col));
  s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
}

// The end of the run of packed rows from p on (below p_end) over which both
// nibbles' scale groups stay the same
__device__ __forceinline__ int run_end(int p, int p_end, int tile_k, int group) {
  int klo, khi;
  packed_row(p, tile_k, klo, khi);
  const int half = tile_k / 2;
  const int tile_end = (p / half + 1) * half;
  return min(min(p_end, tile_end),
             p + min((klo / group + 1) * group - klo, (khi / group + 1) * group - khi));
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) rk_mlp4_gate_up_kernel(
    const T* __restrict__ x, const float* __restrict__ nw,
    const uint32_t* __restrict__ wg, const float* __restrict__ gs_g,
    const uint32_t* __restrict__ wu, const float* __restrict__ gs_u, int m, int h,
    int inter, int tile_k, int group, float eps, T* __restrict__ act) {
  __shared__ float red[kThreads / 32];
  __shared__ float inv[M];
  __shared__ float part_g[kUpGroups][kUpCols];
  __shared__ float part_u[kUpGroups][kUpCols];
  const int tid = threadIdx.x;

  // 1/rms of each row: f32 sum of squares in a fixed order, / h, + eps
  for (int r = 0; r < m; ++r) {
    float ss = 0.f;
    for (int i = tid; i < h; i += kThreads) {
      const float v = to_f32(x[(size_t)r * h + i]);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (tid % 32 == 0) red[tid / 32] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t += red[w];
      inv[r] = __frsqrt_rn(__fadd_rn(__fdiv_rn(t, (float)h), eps));
    }
    __syncthreads();
  }

  const int cg = tid % (kUpCols / kCols);
  const int kg = tid / (kUpCols / kCols);
  const int col = blockIdx.x * kUpCols + cg * kCols;
  const int rows_per = h / 2 / kUpGroups;
  const int p_end = (kg + 1) * rows_per;
  float ag[M][kCols], au[M][kCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) ag[r][c] = au[r][c] = 0.f;

  for (int p = kg * rows_per; p < p_end;) {
    const int end = run_end(p, p_end, tile_k, group);
    int klo, khi;
    packed_row(p, tile_k, klo, khi);
    float sgl[kCols], sgh[kCols], sul[kCols], suh[kCols];
    load_scales(gs_g, klo / group, inter, col, sgl);
    load_scales(gs_g, khi / group, inter, col, sgh);
    load_scales(gs_u, klo / group, inter, col, sul);
    load_scales(gs_u, khi / group, inter, col, suh);
    for (; p < end; ++p, ++klo, ++khi) {
      const uint32_t g4 = __ldg(wg + ((size_t)p * inter + col) / kCols);
      const uint32_t u4 = __ldg(wu + ((size_t)p * inter + col) / kCols);
      float xl[M], xh[M];
      const float nl = __ldg(nw + klo), nh = __ldg(nw + khi);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        if (r < m) {
          xl[r] = round_to<T>(__fmul_rn(__fmul_rn(to_f32(x[(size_t)r * h + klo]), inv[r]), nl));
          xh[r] = round_to<T>(__fmul_rn(__fmul_rn(to_f32(x[(size_t)r * h + khi]), inv[r]), nh));
        } else {
          xl[r] = xh[r] = 0.f;
        }
      }
      float gl[kCols], gh[kCols], ul[kCols], uh[kCols];
      dequant4<T>(g4, false, sgl, gl);
      dequant4<T>(g4, true, sgh, gh);
      dequant4<T>(u4, false, sul, ul);
      dequant4<T>(u4, true, suh, uh);
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          ag[r][c] = fmaf(xh[r], gh[c], fmaf(xl[r], gl[c], ag[r][c]));
          au[r][c] = fmaf(xh[r], uh[c], fmaf(xl[r], ul[c], au[r][c]));
        }
    }
  }

  // the groups' sums in group order, then act = silu(g) * u
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;  // m is the same for every thread
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      part_g[kg][cg * kCols + c] = ag[r][c];
      part_u[kg][cg * kCols + c] = au[r][c];
    }
    __syncthreads();
    if (tid < kUpCols) {
      float g = 0.f, u = 0.f;
      for (int q = 0; q < kUpGroups; ++q) {
        g += part_g[q][tid];
        u += part_u[q][tid];
      }
      const float silu = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));
      act[(size_t)r * inter + blockIdx.x * kUpCols + tid] = from_f32<T>(__fmul_rn(silu, u));
    }
    __syncthreads();
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) rk_mlp4_down_kernel(
    const T* __restrict__ x, const T* __restrict__ act, const uint32_t* __restrict__ wd,
    const float* __restrict__ gs_d, int m, int h, int inter, int tile_i, int group,
    T* __restrict__ out) {
  __shared__ float part[kDnGroups][kDnCols];
  const int tid = threadIdx.x;
  const int cg = tid % (kDnCols / kCols);
  const int kg = tid / (kDnCols / kCols);
  const int col = blockIdx.x * kDnCols + cg * kCols;
  const int rows_per = inter / 2 / kDnGroups;
  const int p_end = (kg + 1) * rows_per;
  float acc[M][kCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int p = kg * rows_per; p < p_end;) {
    const int end = run_end(p, p_end, tile_i, group);
    int klo, khi;
    packed_row(p, tile_i, klo, khi);
    float sl[kCols], sh[kCols];
    load_scales(gs_d, klo / group, h, col, sl);
    load_scales(gs_d, khi / group, h, col, sh);
    for (; p < end; ++p, ++klo, ++khi) {
      const uint32_t d4 = __ldg(wd + ((size_t)p * h + col) / kCols);
      float al[M], ah[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        al[r] = r < m ? to_f32(act[(size_t)r * inter + klo]) : 0.f;
        ah[r] = r < m ? to_f32(act[(size_t)r * inter + khi]) : 0.f;
      }
      float dl[kCols], dh[kCols];
      dequant4<T>(d4, false, sl, dl);
      dequant4<T>(d4, true, sh, dh);
#pragma unroll
      for (int r = 0; r < M; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(ah[r], dh[c], fmaf(al[r], dl[c], acc[r][c]));
    }
  }

#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;  // m is the same for every thread
#pragma unroll
    for (int c = 0; c < kCols; ++c) part[kg][cg * kCols + c] = acc[r][c];
    __syncthreads();
    if (tid < kDnCols) {
      float d = 0.f;
      for (int q = 0; q < kDnGroups; ++q) d += part[q][tid];
      const size_t o = (size_t)r * h + blockIdx.x * kDnCols + tid;
      out[o] = from_f32<T>(__fadd_rn(to_f32(x[o]), d));
    }
    __syncthreads();
  }
}

template <typename T, int M>
int launch(const void* x, const float* nw, const int8_t* wg, const float* gs_g,
           const int8_t* wu, const float* gs_u, const int8_t* wd, const float* gs_d,
           int m, int h, int inter, int tile_k, int group_h, int tile_i, int group_i,
           float eps, void* act, void* out, cudaStream_t s) {
  rk_mlp4_gate_up_kernel<T, M><<<inter / kUpCols, kThreads, 0, s>>>(
      static_cast<const T*>(x), nw, reinterpret_cast<const uint32_t*>(wg), gs_g,
      reinterpret_cast<const uint32_t*>(wu), gs_u, m, h, inter, tile_k, group_h, eps,
      static_cast<T*>(act));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rk_mlp4_down_kernel<T, M><<<h / kDnCols, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(act),
      reinterpret_cast<const uint32_t*>(wd), gs_d, m, h, inter, tile_i, group_i,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int m, const void* x, const float* nw, const int8_t* wg, const float* gs_g,
             const int8_t* wu, const float* gs_u, const int8_t* wd, const float* gs_d,
             int h, int inter, int tile_k, int group_h, int tile_i, int group_i,
             float eps, void* act, void* out, cudaStream_t s) {
  if (m <= 1)
    return launch<T, 1>(x, nw, wg, gs_g, wu, gs_u, wd, gs_d, m, h, inter, tile_k,
                        group_h, tile_i, group_i, eps, act, out, s);
  if (m <= 2)
    return launch<T, 2>(x, nw, wg, gs_g, wu, gs_u, wd, gs_d, m, h, inter, tile_k,
                        group_h, tile_i, group_i, eps, act, out, s);
  if (m <= 4)
    return launch<T, 4>(x, nw, wg, gs_g, wu, gs_u, wd, gs_d, m, h, inter, tile_k,
                        group_h, tile_i, group_i, eps, act, out, s);
  return launch<T, 8>(x, nw, wg, gs_g, wu, gs_u, wd, gs_d, m, h, inter, tile_k,
                      group_h, tile_i, group_i, eps, act, out, s);
}


// ---------------------------------------------------------------------------
// The tensor-core route: bf16 x
// ---------------------------------------------------------------------------

constexpr int kMmaStrip = 512;                 // columns a block (4 warps x 128)
constexpr int kGuThreads = 256;                // gate/up: warps 0-3 gate, 4-7 up
constexpr int kDnThreads = 128;                // down: #4's 4 warps
constexpr int kReduceThreads = 256;
constexpr int kMaxRows = 8;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// inv[r] = 1 / sqrt(mean(x[r]^2) + eps) for rows r < m, in f32: a thread's
// 16-byte chunks i, i + blockDim, ..., then a warp's xor tree, then the warps
// in order. One __syncthreads pair for all rows.
__device__ __forceinline__ void rms_inv(const __nv_bfloat16* __restrict__ x, int m, int h,
                                        float eps, float* red, float* inv) {
  float ss[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) ss[r] = 0.f;
  for (int i = threadIdx.x; i < h / 8; i += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < m) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * h) + i);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ss[r] = fmaf(bf16_lo(u[q]), bf16_lo(u[q]), ss[r]);
          ss[r] = fmaf(bf16_hi(u[q]), bf16_hi(u[q]), ss[r]);
        }
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], o);
    if (lane == 0) red[warp * kMaxRows + r] = ss[r];
  }
  __syncthreads();
  if ((int)threadIdx.x < m) {
    float t = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) t += red[w * kMaxRows + threadIdx.x];
    inv[threadIdx.x] = __frsqrt_rn(__fadd_rn(__fdiv_rn(t, (float)h), eps));
  }
  __syncthreads();
}

// The staged x (int4_decode_mma.cuh's k order) is written an item at a
// time: item i = 8 kb + r holds row r's values at the 16 packed rows of
// k-block kb, 8 words, word 2 c' + h packed rows c' and c' + 4 of nibble h;
// the values of each nibble come from one 16-byte load at x column klo + h
// * half + 8 kb.
__device__ __forceinline__ void item_words(const uint4& v, int hh, uint32_t (&wd)[8]) {
  wd[hh] = __byte_perm(v.x, v.z, 0x5410);       // values 0, 4
  wd[2 + hh] = __byte_perm(v.x, v.z, 0x7632);   // 1, 5
  wd[4 + hh] = __byte_perm(v.y, v.w, 0x5410);   // 2, 6
  wd[6 + hh] = __byte_perm(v.y, v.w, 0x7632);   // 3, 7
}

// the same of x * s * nw in f32 rounded to bf16 (RMSNorm's output), nw the
// norm weights at the 8 values
__device__ __forceinline__ void item_words_norm(const uint4& v, int hh, const float4 (&nw)[2],
                                                float s, uint32_t (&wd)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};   // values 2q (low half), 2q + 1
  const float nv[8] = {nw[0].x, nw[0].y, nw[0].z, nw[0].w, nw[1].x, nw[1].y, nw[1].z, nw[1].w};
  float f[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __fmul_rn(__fmul_rn(bf16_lo(u[q]), s), nv[2 * q]);
    f[2 * q + 1] = __fmul_rn(__fmul_rn(bf16_hi(u[q]), s), nv[2 * q + 1]);
  }
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) wd[2 * cc + hh] = pack_bf16x2(f[cc], f[cc + 4]);
}

__device__ __forceinline__ void store_item(uint32_t* xa, int i, const uint32_t (&wd)[8]) {
  uint4* dst = reinterpret_cast<uint4*>(xa + (size_t)i * 8);
  dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  dst[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
}

// Rows [0, m) of act (row stride k, bf16) at a slice's packed rows, staged,
// zeros for rows m..7
__device__ __forceinline__ void stage_slice(uint32_t* __restrict__ xa,
                                            const __nv_bfloat16* __restrict__ x, int m, int k,
                                            int klo, int half, int kblocks) {
  for (int i = threadIdx.x; i < kblocks * 8; i += blockDim.x) {
    const int kb = i / 8, r = i % 8;
    uint32_t wd[8];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __nv_bfloat16* src = x + (size_t)r * k + klo + hh * half + 8 * kb;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < m) v = __ldcg(reinterpret_cast<const uint4*>(src));
      item_words(v, hh, wd);
    }
    store_item(xa, i, wd);
  }
}

// The gate/up prologue, in one round trip of loads: thread i reads item i's
// x values and norm weights (kblocks * 8 <= blockDim), then its share of
// every row for rms_inv, and stages x * 1/rms * nw rounded to bf16
__device__ __forceinline__ void stage_rms_slice(uint32_t* __restrict__ xa,
                                                const __nv_bfloat16* __restrict__ x,
                                                const float* __restrict__ nw, int m, int h,
                                                int klo, int half, int kblocks, float eps,
                                                float* red, float* inv) {
  const int i = threadIdx.x, kb = i / 8, r = i % 8;
  const bool item = i < kblocks * 8;
  uint4 v[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  float4 n[2][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = klo + hh * half + 8 * kb;
    if (item && r < m) v[hh] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * h + col));
    if (item) {
      n[hh][0] = __ldg(reinterpret_cast<const float4*>(nw + col));
      n[hh][1] = __ldg(reinterpret_cast<const float4*>(nw + col) + 1);
    }
  }
  rms_inv(x, m, h, eps, red, inv);
  if (!item) return;
  const float s = r < m ? inv[r] : 0.f;
  uint32_t wd[8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) item_words_norm(v[hh], hh, n[hh], s, wd);
  store_item(xa, i, wd);
}

// A lane's sums (x rows 2c and 2c + 1 of its 16 columns, rows below m) into
// the (m, n) partial p at column col
__device__ __forceinline__ void write_rows(const float (&d)[8][4], int m,
                                           float* __restrict__ p, int n, int col) {
  float v[2][16];
  mma_rows(d, v);
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 2 * c + hh;
    if (r >= m) break;
    float4* o = reinterpret_cast<float4*>(p + (size_t)r * n + col);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = make_float4(v[hh][4 * i], v[hh][4 * i + 1], v[hh][4 * i + 2], v[hh][4 * i + 3]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
}

// act = silu(g) * u rounded to bf16, g and u the slices' partials
// (part: [slice][gate, up][row][column]) added in slice order, over 4-column
// groups of columns [c0, c0 + cols) of every row: thread t of `threads`
// takes groups t, t + threads, ...
__device__ __forceinline__ void gate_up_sum(const float* __restrict__ part, int slices, int m,
                                            int inter, int c0, int cols, int t, int threads,
                                            __nv_bfloat16* __restrict__ act) {
  const int per_row = cols / 4;
  const size_t plane = (size_t)m * inter;
  for (int i = t; i < m * per_row; i += threads) {
    const int r = i / per_row, cc = c0 + 4 * (i - r * per_row);
    const float* p = part + (size_t)r * inter + cc;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f), u = g;
#pragma unroll 4
    for (int s = 0; s < slices; ++s) {
      add4(g, __ldcg(reinterpret_cast<const float4*>(p + 2 * s * plane)));
      add4(u, __ldcg(reinterpret_cast<const float4*>(p + (2 * s + 1) * plane)));
    }
    *reinterpret_cast<uint2*>(act + (size_t)r * inter + cc) =
        make_uint2(pack_bf16x2(silu_mul(g.x, u.x), silu_mul(g.y, u.y)),
                   pack_bf16x2(silu_mul(g.z, u.z), silu_mul(g.w, u.w)));
  }
}

// out = x + the slices' partials (part: [slice][row][column]) added in
// slice order, in f32, rounded once; columns and threads as gate_up_sum
__device__ __forceinline__ void down_sum(const float* __restrict__ part, int slices, int m,
                                         int h, const __nv_bfloat16* __restrict__ x, int c0,
                                         int cols, int t, int threads,
                                         __nv_bfloat16* __restrict__ out) {
  const int per_row = cols / 4;
  const size_t plane = (size_t)m * h;
  for (int i = t; i < m * per_row; i += threads) {
    const int r = i / per_row, cc = c0 + 4 * (i - r * per_row);
    const size_t o = (size_t)r * h + cc;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < slices; ++s)
      add4(d, __ldcg(reinterpret_cast<const float4*>(part + s * plane + o)));
    const uint2 xv = *reinterpret_cast<const uint2*>(x + o);
    *reinterpret_cast<uint2*>(out + o) =
        make_uint2(pack_bf16x2(__fadd_rn(bf16_lo(xv.x), d.x), __fadd_rn(bf16_hi(xv.x), d.y)),
                   pack_bf16x2(__fadd_rn(bf16_lo(xv.y), d.z), __fadd_rn(bf16_hi(xv.y), d.w)));
  }
}

// Gate and up: grid (I / 512 strips, slices of h). tickets == nullptr: the
// partials are summed by rk_mlp4_gate_up_reduce_kernel.
__global__ void __launch_bounds__(kGuThreads, 2) rk_mlp4_gate_up_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ nw,
    const int8_t* __restrict__ wg, const float* __restrict__ gs_g,
    const int8_t* __restrict__ wu, const float* __restrict__ gs_u, int m, int h, int inter,
    int tile_k, int group, int k_slice, float eps, float* __restrict__ part,
    unsigned* __restrict__ tickets, __nv_bfloat16* __restrict__ act) {
  extern __shared__ __align__(16) uint32_t xa[];
  __shared__ float red[kGuThreads / 32 * kMaxRows];
  __shared__ float inv[kMaxRows];
  __shared__ int last;
  const int half = tile_k / 2;
  const MmaSlice sl(tile_k, k_slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int up = warp >= 4;
  const int col = blockIdx.x * kMmaStrip + (warp % 4) * 128 + g * 16;
  const int8_t* wp = (up ? wu : wg) + ((size_t)sl.tile * half + sl.pr0 + c) * inter + col;
  KBlock A;
  mma_load(A, wp, inter, 0, sl.kblocks);  // in flight during the prologue
  stage_rms_slice(xa, x, nw, m, h, sl.klo, half, sl.kblocks, eps, red, inv);
  __syncthreads();

  float d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
  const float* gs = up ? gs_u : gs_g;
  int4_mma_stream<false>(xa, m, wp, gs + (size_t)sl.tile * (tile_k / group) * inter + col,
                         inter, half, sl.pr0, group, sl.kblocks, A, d);
  write_rows(d, m, part + ((size_t)blockIdx.y * 2 + up) * m * inter, inter, col);
  if (tickets == nullptr || !last_of_strip(tickets + blockIdx.x, gridDim.y, &last)) return;
  gate_up_sum(part, gridDim.y, m, inter, blockIdx.x * kMmaStrip, kMmaStrip, threadIdx.x,
              kGuThreads, act);
}

// Down: grid (h / 512 strips, slices of I); tickets == nullptr: the
// partials are summed by rk_mlp4_down_reduce_kernel.
__global__ void __launch_bounds__(kDnThreads) rk_mlp4_down_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ act,
    const int8_t* __restrict__ wd, const float* __restrict__ gs_d, int m, int h, int inter,
    int tile_i, int group, int k_slice, float* __restrict__ part,
    unsigned* __restrict__ tickets, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t xa[];
  __shared__ int last;
  const int half = tile_i / 2;
  const MmaSlice sl(tile_i, k_slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int col = blockIdx.x * kMmaStrip + warp * 128 + g * 16;
  const int8_t* wp = wd + ((size_t)sl.tile * half + sl.pr0 + c) * h + col;
  KBlock A;
  mma_load(A, wp, h, 0, sl.kblocks);  // in flight while act is staged
  stage_slice(xa, act, m, inter, sl.klo, half, sl.kblocks);
  __syncthreads();

  float d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
  int4_mma_stream<false>(xa, m, wp, gs_d + (size_t)sl.tile * (tile_i / group) * h + col, h,
                         half, sl.pr0, group, sl.kblocks, A, d);
  write_rows(d, m, part + (size_t)blockIdx.y * m * h, h, col);
  if (tickets == nullptr || !last_of_strip(tickets + blockIdx.x, gridDim.y, &last)) return;
  down_sum(part, gridDim.y, m, h, x, blockIdx.x * kMmaStrip, kMmaStrip, threadIdx.x, kDnThreads,
           out);
}

__global__ void __launch_bounds__(kReduceThreads) rk_mlp4_gate_up_reduce_kernel(
    const float* __restrict__ part, int slices, int m, int inter,
    __nv_bfloat16* __restrict__ act) {
  gate_up_sum(part, slices, m, inter, 0, inter, blockIdx.x * kReduceThreads + threadIdx.x,
              gridDim.x * kReduceThreads, act);
}

__global__ void __launch_bounds__(kReduceThreads) rk_mlp4_down_reduce_kernel(
    const float* __restrict__ part, int slices, int m, int h,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out) {
  down_sum(part, slices, m, h, x, 0, h, blockIdx.x * kReduceThreads + threadIdx.x,
           gridDim.x * kReduceThreads, out);
}

int reduce_blocks(int m, int n) { return (m * n / 4 + kReduceThreads - 1) / kReduceThreads; }

int launch_mma(const __nv_bfloat16* x, const float* nw, const int8_t* wg, const float* gs_g,
               const int8_t* wu, const float* gs_u, const int8_t* wd, const float* gs_d, int m,
               int h, int inter, int tile_k, int group_h, int tile_i, int group_i, float eps,
               int ks_gu, int ks_dn, bool last_block, float* part_gu, float* part_dn,
               unsigned* tickets, __nv_bfloat16* act, __nv_bfloat16* out, cudaStream_t s) {
  const int strips_gu = inter / kMmaStrip, strips_dn = h / kMmaStrip;
  const int slices_gu = decode_slices(h, tile_k, ks_gu);
  const int slices_dn = decode_slices(inter, tile_i, ks_dn);
  unsigned* t_gu = last_block ? tickets : nullptr;
  unsigned* t_dn = last_block ? tickets + strips_gu : nullptr;
  rk_mlp4_gate_up_mma_kernel<<<dim3(strips_gu, slices_gu), kGuThreads, (size_t)32 * ks_gu, s>>>(
      x, nw, wg, gs_g, wu, gs_u, m, h, inter, tile_k, group_h, ks_gu, eps, part_gu, t_gu, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!last_block) {
    rk_mlp4_gate_up_reduce_kernel<<<reduce_blocks(m, inter), kReduceThreads, 0, s>>>(
        part_gu, slices_gu, m, inter, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rk_mlp4_down_mma_kernel<<<dim3(strips_dn, slices_dn), kDnThreads, (size_t)32 * ks_dn, s>>>(
      x, act, wd, gs_d, m, h, inter, tile_i, group_i, ks_dn, part_dn, t_dn, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!last_block) {
    rk_mlp4_down_reduce_kernel<<<reduce_blocks(m, h), kReduceThreads, 0, s>>>(
        part_dn, slices_dn, m, h, x, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, h) in dtype (0 = float32, 1 = bfloat16), 1 <= m <= 8; nw (h,) f32;
// wg_p/wu_p (h/2, inter) packed per tile_k rows with gs_g/gs_u
// (h/group_h, inter) f32; wd_p (inter/2, h) packed per tile_i rows with gs_d
// (inter/group_i, h) f32; act (m, inter) in dtype is scratch; out (m, h) in
// dtype. Groups divide their tiles; h % tile_k == 0, inter % tile_i == 0.
//
// route 0, the scalar kernels (any dtype): h % 64 == 0, inter % 128 == 0,
// tiles of at least 64 rows (each thread group's share of packed rows is
// whole); ks_gu, ks_dn, part_gu, part_dn and tickets are not read.
// route 1 (last-block sums) and 2 (reduce launches), the tensor-core
// kernels: bf16, h % 512 == 0, inter % 512 == 0; gate/up cut into slices of
// ks_gu packed rows of each tile_k tile (at most 256), down into slices of
// ks_dn of each tile_i tile (at most 1536); multiples of 8, at most the
// half tile; groups a multiple of 8 or the tile. part_gu holds slices_gu *
// 2 * m * inter floats, part_dn slices_dn * m * h; route 1 takes tickets,
// inter/512 + h/512 zeroed words that it leaves zero. Returns a
// cudaError_t.
int rk_fused_mlp_int4(const void* x, const float* nw, const int8_t* wg_p,
                      const float* gs_g, const int8_t* wu_p, const float* gs_u,
                      const int8_t* wd_p, const float* gs_d, int m, int h, int inter,
                      int tile_k, int group_h, int tile_i, int group_i, float eps,
                      int dtype, int route, int ks_gu, int ks_dn, float* part_gu,
                      float* part_dn, unsigned* tickets, void* act, void* out, void* stream) {
  if (m < 1 || m > 8 || tile_k % 2 || tile_i % 2 || h % tile_k || inter % tile_i ||
      group_h < 1 || tile_k % group_h || group_i < 1 || tile_i % group_i)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 || route == 2) {
    if (dtype != 1 || h % kMmaStrip || inter % kMmaStrip || ks_gu < 8 || ks_dn < 8 ||
        ks_gu > tile_k / 2 || ks_dn > tile_i / 2 || ks_gu > kGuThreads ||
        !mma_takes(tile_k, group_h, ks_gu) || !mma_takes(tile_i, group_i, ks_dn) ||
        (route == 1 && tickets == nullptr))
      return (int)cudaErrorInvalidValue;
    return launch_mma(static_cast<const __nv_bfloat16*>(x), nw, wg_p, gs_g, wu_p, gs_u, wd_p,
                      gs_d, m, h, inter, tile_k, group_h, tile_i, group_i, eps, ks_gu, ks_dn,
                      route == 1, part_gu, part_dn, tickets, static_cast<__nv_bfloat16*>(act),
                      static_cast<__nv_bfloat16*>(out), s);
  }
  if (route != 0 || h % 64 || inter % 128 || (h / 2) % kUpGroups || (inter / 2) % kDnGroups)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(m, x, nw, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, h,
                                   inter, tile_k, group_h, tile_i, group_i, eps, act,
                                   out, s);
  return dispatch<float>(m, x, nw, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, h, inter,
                         tile_k, group_h, tile_i, group_i, eps, act, out, s);
}

}  // extern "C"
