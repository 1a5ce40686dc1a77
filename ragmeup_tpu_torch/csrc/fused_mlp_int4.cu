// Fused transformer MLP over packed-int4 weights for Hopper (sm_90a):
//   out (m, h) = x + down(silu(gate(rms(x))) * up(rms(x)))   with m <= 8,
// gate/up w_p (h/2, I) with gscale (h/group_h, I), down w_p (I/2, h) with
// gscale (I/group_i, h); packing per k-tile as in ops/quant_matmul.py.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/quant_matmul.py::_mlp_kernel4.
// At decode the MLP is bound by reading its packed weights once: at the
// Llama-3.1-8B shape (h 4096, I 14336, group 128) 88 MB of nibbles and
// 5.5 MB of scales, 0.028 ms at 3.35 TB/s. The TPU kernel carries the gate
// and up sums and the output sum across one sequential grid; Hopper blocks
// carry nothing between them, so this is two launches:
//
//   1. rk_mlp4_gate_up: a block owns 64 columns of I. It takes the RMS of
//      each row of x (f32, a fixed-order block reduction), then 16 groups of
//      16 threads each sum a sixteenth of h for 4 columns a thread, with
//      x normalised, times the norm weight and rounded to x's dtype on the
//      fly. The groups' sums are added in group order in shared memory and
//      act = silu(g) * u, rounded to x's dtype, is written to a scratch
//      (m, I) (229 KB at m = 8).
//   2. rk_mlp4_down: a block owns 32 columns of h; 32 groups of 8 threads
//      each sum a thirty-second of I over act, the groups are added in group
//      order, plus the residual x in f32, rounded once.
//
// Each thread reads 4 adjacent packed columns as one 4-byte load, so a
// group reads 64 (gate/up) or 32 (down) contiguous bytes of a packed row.
// Every weight is dequantized as the TPU kernel does it, f32(q) * f32(scale)
// rounded to x's dtype, at every group size (this kernel has no
// output-scaled route), and products are summed in f32. No atomics: a
// decode repeats bit for bit. No wide loads, cp.async or tensor cores yet.

#include "common.cuh"

namespace {

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

}  // namespace

extern "C" {

// x (m, h) in dtype (0 = float32, 1 = bfloat16), 1 <= m <= 8; nw (h,) f32;
// wg_p/wu_p (h/2, inter) packed per tile_k rows with gs_g/gs_u
// (h/group_h, inter) f32; wd_p (inter/2, h) packed per tile_i rows with gs_d
// (inter/group_i, h) f32; act (m, inter) in dtype is scratch; out (m, h) in
// dtype. Groups divide their tiles; h % tile_k == 0, inter % tile_i == 0,
// h % 64 == 0, inter % 128 == 0, tiles of at least 64 rows (so that each
// thread group's share of packed rows is whole). Returns a cudaError_t.
int rk_fused_mlp_int4(const void* x, const float* nw, const int8_t* wg_p,
                      const float* gs_g, const int8_t* wu_p, const float* gs_u,
                      const int8_t* wd_p, const float* gs_d, int m, int h, int inter,
                      int tile_k, int group_h, int tile_i, int group_i, float eps,
                      int dtype, void* act, void* out, void* stream) {
  if (m < 1 || m > 8 || h % 64 || inter % 128 || tile_k % 2 || tile_i % 2 ||
      h % tile_k || inter % tile_i || group_h < 1 || tile_k % group_h ||
      group_i < 1 || tile_i % group_i || (h / 2) % kUpGroups || (inter / 2) % kDnGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(m, x, nw, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, h,
                                   inter, tile_k, group_h, tile_i, group_i, eps, act,
                                   out, s);
  return dispatch<float>(m, x, nw, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, h, inter,
                         tile_k, group_h, tile_i, group_i, eps, act, out, s);
}

}  // extern "C"
