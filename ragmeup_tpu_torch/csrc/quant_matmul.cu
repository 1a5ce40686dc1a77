// W8A16 decode matmul for Hopper (sm_90a):
//   out (m, n) = (x (m, k) @ w_q (k, n) int8) * scale (n,)   with m <= 8.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/quant_matmul.py::_kernel. At
// decode a projection has one to eight rows, so the product is bound by
// reading the int8 weights once (k * n bytes); arithmetic is small beside it,
// and the kernel is built to keep enough weight bytes in flight. Design:
//
//   * A block owns a strip of 512 columns and a slice of k rows; its 8 warps
//     each walk a contiguous run of the slice's rows. A lane loads 16
//     adjacent columns of a row as one 16-byte ld.global.nc, so a warp reads
//     512 contiguous bytes of the row per load.
//   * Bytes in flight: a thread keeps two register batches of kBatch rows
//     (8 rows for m <= 4, 4 for m = 8, whose 128 accumulators need the
//     registers) and issues the next batch's loads before it consumes the
//     current one: up to 2 x 8 x 16 = 256 bytes a thread, 64 KB for a block
//     of 256 threads. The plan (ops/quant_matmul.py::int8_matmul_plan) aims
//     at two blocks on every SM, so an SM holds 64-128 KB of weight loads in
//     flight; a device-memory stream needs about 16 KB an SM.
//   * int8 -> f32 without the conversion unit: byte b + 128 is placed under
//     the exponent of 2^23 (one PRMT) and 2^23 + 128 subtracted (exact).
//   * x's slice is staged once per block in shared memory as f32, rows
//     interleaved ([k row][m]) so a lane reads all m values of a k row with
//     one or two vector loads (a broadcast: every lane reads the same row).
//   * Split-K is first inside the block: the 8 warps' f32 sums are added in
//     shared memory in warp order. Split across blocks only where the column
//     strips alone leave SMs idle (every 8B projection at m <= 8): each
//     slice writes an f32 partial and a second kernel adds the slices in
//     slice order and applies the scale. The second launch is kept rather
//     than a last-block counter: a counter needs memory zeroed before every
//     launch (a memset launch of its own) or a persistent buffer that two
//     streams could race on. One slice writes the output directly.
//   No atomics: a greedy decode repeats bit for bit from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 16;
constexpr int kColsPerBlock = 32 * kColsPerLane;         // 512
constexpr int kRedFloats = kWarps * kColsPerBlock;        // warp sums of one x row
constexpr int kMaxXsFloats = 12288;                       // 48 KB of staged x

__device__ __forceinline__ int4 ld_nc16(const void* p) {
  int4 r;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(__cvta_generic_to_global(p)));
  return r;
}

// byte b (0..3) of a word whose sign bits were flipped, as a float
__device__ __forceinline__ float i8_at(uint32_t flipped, int b) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | b)) - 8388736.f;
}

template <int M>
__device__ __forceinline__ void x_row(const float* xs, float (&xv)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int r = 0; r < M; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + r);
      xv[r] = v.x; xv[r + 1] = v.y; xv[r + 2] = v.z; xv[r + 3] = v.w;
    }
  } else if constexpr (M == 2) {
    const float2 v = *reinterpret_cast<const float2*>(xs);
    xv[0] = v.x; xv[1] = v.y;
  } else {
    xv[0] = xs[0];
  }
}

// acc[r][c] += x[r] * w[c] over the 16 int8 columns of one k row
template <int M>
__device__ __forceinline__ void consume(const int4& wv, const float* xs,
                                        float (&acc)[M][kColsPerLane]) {
  float xv[M];
  x_row<M>(xs, xv);
  const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y, (uint32_t)wv.z,
                             (uint32_t)wv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t u = words[q] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float w = i8_at(u, b);
#pragma unroll
      for (int r = 0; r < M; ++r) acc[r][4 * q + b] = fmaf(xv[r], w, acc[r][4 * q + b]);
    }
  }
}

template <typename T, int M, int kBatch>
__global__ void __launch_bounds__(kThreads) rk_int8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, int m, int k, int n, int k_slice,
    float* __restrict__ partial, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [rows][M], then the warp sums
  const int k0 = blockIdx.y * k_slice;
  const int rows = min(k_slice, k - k0);
  for (int i = threadIdx.x; i < M * rows; i += kThreads) {
    const int r = i / rows, j = i - r * rows;
    xs[j * M + r] = r < m ? to_f32(x[(size_t)r * k + k0 + j]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kColsPerBlock + lane * kColsPerLane;
  const int per_warp = (rows + kWarps - 1) / kWarps;
  const int j0 = min(rows, warp * per_warp);
  const int j1 = min(rows, j0 + per_warp);

  float acc[M][kColsPerLane];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;

  if (col < n) {
    const int8_t* wp = w + (size_t)k0 * n + col;
    int4 a[kBatch], b[kBatch];
    auto load = [&](int4 (&buf)[kBatch], int j) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        buf[u] = j + u < j1 ? ld_nc16(wp + (size_t)(j + u) * n) : make_int4(0, 0, 0, 0);
    };
    auto use = [&](const int4 (&buf)[kBatch], int j) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j + u < j1) consume<M>(buf[u], xs + (j + u) * M, acc);
    };
    load(a, j0);
    for (int j = j0; j < j1; j += 2 * kBatch) {
      load(b, j + kBatch);       // in flight while `a` is consumed
      use(a, j);
      load(a, j + 2 * kBatch);   // in flight while `b` is consumed
      use(b, j + kBatch);
    }
  }

  // add the warps' sums in warp order, one x row at a time
  float* red = smem;  // [kWarps][kColsPerBlock], over x's rows
  const int nslices = gridDim.y;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;
    __syncthreads();   // x (first row) or the previous row's sums are read
    float4* dst = reinterpret_cast<float4*>(red + warp * kColsPerBlock + lane * kColsPerLane);
#pragma unroll
    for (int c = 0; c < kColsPerLane; c += 4)
      dst[c / 4] = make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    __syncthreads();
    for (int cc = threadIdx.x; cc < kColsPerBlock; cc += kThreads) {
      const int oc = blockIdx.x * kColsPerBlock + cc;
      if (oc >= n) continue;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kColsPerBlock + cc];
      if (nslices == 1)
        out[(size_t)r * n + oc] = from_f32<T>(s * scale[oc]);
      else
        partial[((size_t)blockIdx.y * m + r) * n + oc] = s;
    }
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

template <typename T, int M, int kBatch>
cudaError_t launch_slices(const T* x, const int8_t* w, const float* scale, int m,
                          int k, int n, int k_slice, float* partial, T* out,
                          cudaStream_t stream) {
  if ((size_t)k_slice * M > kMaxXsFloats) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)max(k_slice * M, kRedFloats) * sizeof(float);
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, (k + k_slice - 1) / k_slice);
  rk_int8_matmul_kernel<T, M, kBatch><<<grid, kThreads, bytes, stream>>>(
      x, w, scale, m, k, n, k_slice, partial, out);
  return cudaGetLastError();
}

template <typename T>
int launch_int8_matmul(const void* xv, const int8_t* w, const float* scale,
                       int m, int k, int n, int k_slice, float* partial,
                       void* outv, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  cudaError_t err;
  if (m <= 1) err = launch_slices<T, 1, 8>(x, w, scale, m, k, n, k_slice, partial, out, stream);
  else if (m <= 2) err = launch_slices<T, 2, 8>(x, w, scale, m, k, n, k_slice, partial, out, stream);
  else if (m <= 4) err = launch_slices<T, 4, 8>(x, w, scale, m, k, n, k_slice, partial, out, stream);
  else err = launch_slices<T, 8, 4>(x, w, scale, m, k, n, k_slice, partial, out, stream);
  if (err != cudaSuccess) return (int)err;
  const int splits = (k + k_slice - 1) / k_slice;
  if (splits > 1) {
    const int total = m * n;
    rk_int8_matmul_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
        partial, scale, m, n, splits, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) in dtype (0 = float32, 1 = bfloat16), w_q (k, n) int8 row-major,
// scale (n,) f32, out (m, n) in x's dtype. 1 <= m <= 8, n % 16 == 0,
// k_slice * (m rounded up to 1, 2, 4 or 8) <= 12288; slice i covers rows
// [i * k_slice, min(k, (i + 1) * k_slice)); partial holds
// ceil(k / k_slice) * m * n floats when there is more than one slice.
// Returns a cudaError_t.
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
