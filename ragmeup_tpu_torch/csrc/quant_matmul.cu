// W8A16 decode matmul for Hopper (sm_90a):
//   out (m, n) = (x (m, k) @ w_q (k, n) int8) * scale (n,)   with m <= 8.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/quant_matmul.py::_kernel. At
// decode a projection has one to eight rows, so the product is bound by
// reading the int8 weights once (k * n bytes); arithmetic is a rounding
// error beside it. Design:
//
//   * Each thread owns 4 adjacent output columns and walks its k-slice
//     reading w[j, col:col+4] as one 4-byte load; a warp reads 128
//     contiguous bytes of a weight row, so the stream is coalesced. The
//     slice of x sits in shared memory; accumulation is f32 for all M rows.
//   * The narrow projections (k/v: n = 1024) have too few column blocks to
//     fill 132 SMs, so k is split into slices (grid.y). Each slice writes an
//     f32 partial; a second kernel sums the partials in a fixed order and
//     applies the per-channel scale in the epilogue, as the TPU kernel did.
//     No atomics: a greedy decode repeats bit for bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 512
constexpr int kMaxSlice = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) rk_int8_matmul_partial_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w, int m, int k, int n,
    int k_slice, float* __restrict__ partial) {
  __shared__ float xs[M][kMaxSlice];
  const int k0 = blockIdx.y * k_slice;
  for (int i = threadIdx.x; i < M * k_slice; i += blockDim.x) {
    const int r = i / k_slice;
    const int j = i - r * k_slice;
    xs[r][j] = r < m ? to_f32(x[(size_t)r * k + k0 + j]) : 0.f;
  }
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (col >= n) return;

  float acc[M][kColsPerThread];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;

  const char4* wp = reinterpret_cast<const char4*>(w + (size_t)k0 * n + col);
  const size_t row4 = (size_t)n / kColsPerThread;
#pragma unroll 8
  for (int j = 0; j < k_slice; ++j) {
    const char4 wv = __ldg(wp + (size_t)j * row4);
    const float w0 = wv.x, w1 = wv.y, w2 = wv.z, w3 = wv.w;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const float xv = xs[r][j];
      acc[r][0] = fmaf(xv, w0, acc[r][0]);
      acc[r][1] = fmaf(xv, w1, acc[r][1]);
      acc[r][2] = fmaf(xv, w2, acc[r][2]);
      acc[r][3] = fmaf(xv, w3, acc[r][3]);
    }
  }
  float* out = partial + (size_t)blockIdx.y * m * n;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r < m)
      *reinterpret_cast<float4*>(out + (size_t)r * n + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <typename T>
__global__ void rk_int8_matmul_reduce_kernel(const float* __restrict__ partial,
                                             const float* __restrict__ scale,
                                             int m, int n, int splits,
                                             T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * m * n + idx];
  out[idx] = from_f32<T>(s * scale[idx % n]);
}

template <typename T, int M>
cudaError_t launch_partial(const T* x, const int8_t* w, int m, int k, int n,
                           int k_slice, float* partial, cudaStream_t stream) {
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, k / k_slice);
  rk_int8_matmul_partial_kernel<T, M><<<grid, kThreads, 0, stream>>>(
      x, w, m, k, n, k_slice, partial);
  return cudaGetLastError();
}

template <typename T>
int launch_int8_matmul(const void* xv, const int8_t* w, const float* scale,
                       int m, int k, int n, int k_slice, float* partial,
                       void* outv, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  cudaError_t err;
  if (m <= 1) err = launch_partial<T, 1>(x, w, m, k, n, k_slice, partial, stream);
  else if (m <= 2) err = launch_partial<T, 2>(x, w, m, k, n, k_slice, partial, stream);
  else if (m <= 4) err = launch_partial<T, 4>(x, w, m, k, n, k_slice, partial, stream);
  else err = launch_partial<T, 8>(x, w, m, k, n, k_slice, partial, stream);
  if (err != cudaSuccess) return (int)err;
  const int total = m * n;
  rk_int8_matmul_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      partial, scale, m, n, k / k_slice, static_cast<T*>(outv));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) in dtype (0 = float32, 1 = bfloat16), w_q (k, n) int8 row-major,
// scale (n,) f32, out (m, n) in x's dtype. 1 <= m <= 8, n % 4 == 0,
// k % k_slice == 0, k_slice <= 256; partial holds (k / k_slice) * m * n
// floats. Returns a cudaError_t.
int rk_int8_matmul(const void* x, const int8_t* w, const float* scale, int m,
                   int k, int n, int k_slice, int dtype, float* partial,
                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_int8_matmul<__nv_bfloat16>(x, w, scale, m, k, n, k_slice,
                                             partial, out, s);
  return launch_int8_matmul<float>(x, w, scale, m, k, n, k_slice, partial, out,
                                   s);
}

}  // extern "C"
