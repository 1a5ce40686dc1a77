// Packed-int4 weight matmuls for Hopper (sm_90a):
//   out (m, n) = x (m, k) @ dequant(w_p (k/2, n), gscale (k/group, n))
// with 1 <= m <= 256 and n % 512 == 0, and the per-slot expert gather
//   out[s] = x[s] @ dequant(w_p[ids[s]] (k/2, n), gscale[ids[s]] (k/group, n))
// over stacked experts w_p (E, k/2, n), gscale (E, k/group, n), at most 64
// slots, n % 256 == 0.
//
// Replaces the Pallas kernels ragmeup_tpu/ops/quant_matmul.py::_kernel4
// (W4A16) and ::_kernel4_a8 (W4A8), and ragmeup_tpu/ops/moe_matmul.py::
// _kernel4 (the gather, rk_moe_gather_int4). Packing is per k-tile of tile_k rows:
// byte j of a tile holds row j in its low nibble and row j + tile_k/2 in its
// high nibble, so one byte feeds two x values of the same tile.
//
// At decode (m = 1) the product is bound by reading the packed weights once
// (k * n / 2 bytes, half of int8); the arithmetic per byte is a few
// conversions and FMAs. Design, shared by both kernels:
//
//   * Each thread owns 8 adjacent output columns and reads w_p[j, col:col+8]
//     as one 8-byte load per packed row: a warp reads 256 contiguous bytes.
//     Signed nibbles come out of the word with arithmetic shifts.
//   * k is split into slices of packed rows (grid.y) that never cross a
//     k-tile, so a slice has one tile scale (output-scaled routes). Each
//     slice writes a partial; a second kernel sums the partials in a fixed
//     order (no atomics: greedy decoding repeats bit for bit).
//   * m > 8 walks 8-row groups of x (grid.z); each group re-reads the
//     weights, from L2 where they fit. A decode-shaped design: the 128- and
//     256-row prefill buckets reach it too, at scalar-FMA speed.
//   * The gather runs the W4A16 kernel's body with one slot a block along
//     grid.z (its own kernel names, so a trace tells the two apart): the
//     block reads its slot's expert id from device memory (the TPU kernel's
//     scalar prefetch, no host sync) and offsets the packed weights and the
//     scales by it. At Mixtral decode (2 slots) one layer's gate, up and down
//     are 176 MB of packed experts and 11 MB of group-128 scales: 0.056 ms
//     at 3.35 TB/s, bound by those bytes; the design streams each routed
//     expert's bytes once per slot, 16-byte rows a warp at a time.
//
// Rounding is each route's own, as in the TPU kernel:
//   W4A16 quality (group < tile_k): each weight is dequantized in f32 and
//     rounded to x's dtype, then multiplied with x and summed in f32.
//   W4A16 output-scaled (group == tile_k): x times the unscaled integers,
//     summed in f32 over the slice, times the tile's scale.
//   W4A8 (group == tile_k): a first kernel quantizes each row of x over all
//     of k (scale max(amax, 1e-8) / 127, round half to even); the slices sum
//     int8 x int4 products exactly in int32; the reduce adds each tile's
//     integer slices, then acc + float(p) * x_scale * tile_scale over the
//     tiles in order, one f32 rounding per step, as the plain version does.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kCols = 8;                         // columns per thread
constexpr int kColsPerBlock = kThreads * kCols;  // 512
constexpr int kRowGroup = 8;                     // rows of x per block
constexpr int kMaxSlice = 256;                   // packed rows per block

// Where a block's slice lies: packed rows [p0, p0 + k_slice) of tile `tile`;
// its low-nibble rows start at x column klo, its high-nibble rows at khi.
struct Slice {
  int p0, tile, klo, khi;
  __device__ Slice(int k_slice, int tile_k) {
    const int half = tile_k / 2;
    p0 = blockIdx.y * k_slice;
    tile = p0 / half;
    klo = tile * tile_k + (p0 - tile * half);
    khi = klo + half;
  }
};

// The W4A16 split-K partial of rows [row0, row0 + M) of x (those below m)
// against w / gs, for the block's column strip and slice.
template <typename T, int M, bool kOutScaled>
__device__ __forceinline__ void int4_partial(
    const T* __restrict__ x, const uint2* __restrict__ w,
    const float* __restrict__ gs, int row0, int m, int k, int n, int tile_k,
    int group, int k_slice, float* __restrict__ partial) {
  __shared__ float xs[2][M][kMaxSlice];
  const Slice sl(k_slice, tile_k);
  const int rows = min(M, m - row0);
  for (int i = threadIdx.x; i < M * k_slice; i += kThreads) {
    const int r = i / k_slice;
    const int j = i - r * k_slice;
    const T* xr = x + (size_t)(row0 + r) * k;
    xs[0][r][j] = r < rows ? to_f32(xr[sl.klo + j]) : 0.f;
    xs[1][r][j] = r < rows ? to_f32(xr[sl.khi + j]) : 0.f;
  }
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= n) return;

  float acc[M][kCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const uint2* wp = w + ((size_t)sl.p0 * n + col) / kCols;
  const size_t row8 = (size_t)n / kCols;
  if (kOutScaled) {
#pragma unroll 4
    for (int j = 0; j < k_slice; ++j) {
      const uint2 wv = __ldg(wp + (size_t)j * row8);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float lo = (float)nib_lo(wv, c), hi = (float)nib_hi(wv, c);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          acc[r][c] = fmaf(xs[0][r][j], lo, acc[r][c]);
          acc[r][c] = fmaf(xs[1][r][j], hi, acc[r][c]);
        }
      }
    }
    const float* s = gs + (size_t)sl.tile * n + col;  // group == tile_k
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float sc = __ldg(s + c);
#pragma unroll
      for (int r = 0; r < M; ++r) acc[r][c] = __fmul_rn(acc[r][c], sc);
    }
  } else {
    // runs of packed rows over which both nibbles' scale groups stay fixed
    for (int j = 0; j < k_slice;) {
      const int glo = (sl.klo + j) / group;
      const int ghi = (sl.khi + j) / group;
      const int end = min(k_slice, min((glo + 1) * group - sl.klo,
                                       (ghi + 1) * group - sl.khi));
      float slo[kCols], shi[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        slo[c] = __ldg(gs + (size_t)glo * n + col + c);
        shi[c] = __ldg(gs + (size_t)ghi * n + col + c);
      }
#pragma unroll 2
      for (; j < end; ++j) {
        const uint2 wv = __ldg(wp + (size_t)j * row8);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float lo = round_to<T>(__fmul_rn((float)nib_lo(wv, c), slo[c]));
          const float hi = round_to<T>(__fmul_rn((float)nib_hi(wv, c), shi[c]));
#pragma unroll
          for (int r = 0; r < M; ++r) {
            acc[r][c] = fmaf(xs[0][r][j], lo, acc[r][c]);
            acc[r][c] = fmaf(xs[1][r][j], hi, acc[r][c]);
          }
        }
      }
    }
  }

  float* out = partial + ((size_t)blockIdx.y * m + row0) * n + col;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r < rows) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)r * n);
      o[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      o[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
}

// x's rows in 8-row groups (grid.z) against one weight matrix
template <typename T, int M, bool kOutScaled>
__global__ void __launch_bounds__(kThreads) rk_int4_partial_kernel(
    const T* __restrict__ x, const uint2* __restrict__ w,
    const float* __restrict__ gs, int m, int k, int n, int tile_k, int group,
    int k_slice, float* __restrict__ partial) {
  int4_partial<T, M, kOutScaled>(x, w, gs, blockIdx.z * kRowGroup, m, k, n, tile_k,
                                 group, k_slice, partial);
}

// the gather: slot z (grid.z) against expert ids[z] of the stacks
template <typename T, bool kOutScaled>
__global__ void __launch_bounds__(kThreads) rk_moe_gather_int4_partial_kernel(
    const T* __restrict__ x, const uint2* __restrict__ w,
    const float* __restrict__ gs, const int* __restrict__ ids, int slots, int k,
    int n, int tile_k, int group, int k_slice, float* __restrict__ partial) {
  const size_t e = (size_t)ids[blockIdx.z];
  int4_partial<T, 1, kOutScaled>(x, w + e * (size_t)(k / 2) * (n / kCols),
                                 gs + e * (size_t)(k / group) * n, blockIdx.z, slots, k,
                                 n, tile_k, group, k_slice, partial);
}

template <typename T>
__device__ __forceinline__ void reduce_partials(const float* __restrict__ partial,
                                                int m, int n, int splits,
                                                T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * m * n + idx];
  out[idx] = from_f32<T>(s);
}

template <typename T>
__global__ void rk_int4_reduce_kernel(const float* __restrict__ partial, int m,
                                      int n, int splits, T* __restrict__ out) {
  reduce_partials<T>(partial, m, n, splits, out);
}

template <typename T>
__global__ void rk_moe_gather_int4_reduce_kernel(const float* __restrict__ partial,
                                                 int slots, int n, int splits,
                                                 T* __restrict__ out) {
  reduce_partials<T>(partial, slots, n, splits, out);
}

// One block per row of x: xq = clamp(rint(x / sc), -127, 127) with
// sc = max(amax, 1e-8) / 127 over the whole row, in f32.
constexpr int kQuantThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) rk_quantize_rows_kernel(
    const T* __restrict__ x, int k, int8_t* __restrict__ xq,
    float* __restrict__ x_scale) {
  __shared__ float red[kQuantThreads];
  const T* xr = x + (size_t)blockIdx.x * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  red[threadIdx.x] = amax;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float sc = __fdiv_rn(fmaxf(red[0], 1e-8f), 127.0f);
  int8_t* qr = xq + (size_t)blockIdx.x * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float v = rintf(__fdiv_rn(to_f32(xr[i]), sc));
    qr[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (threadIdx.x == 0) x_scale[blockIdx.x] = sc;
}

template <int M>
__global__ void __launch_bounds__(kThreads) rk_int4_a8_partial_kernel(
    const int8_t* __restrict__ xq, const uint2* __restrict__ w, int m, int k,
    int n, int tile_k, int k_slice, int* __restrict__ partial) {
  __shared__ int xs[2][M][kMaxSlice];
  const Slice sl(k_slice, tile_k);
  const int row0 = blockIdx.z * kRowGroup;
  const int rows = min(M, m - row0);
  for (int i = threadIdx.x; i < M * k_slice; i += kThreads) {
    const int r = i / k_slice;
    const int j = i - r * k_slice;
    const int8_t* xr = xq + (size_t)(row0 + r) * k;
    xs[0][r][j] = r < rows ? (int)xr[sl.klo + j] : 0;
    xs[1][r][j] = r < rows ? (int)xr[sl.khi + j] : 0;
  }
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= n) return;

  int acc[M][kCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0;

  const uint2* wp = w + ((size_t)sl.p0 * n + col) / kCols;
  const size_t row8 = (size_t)n / kCols;
#pragma unroll 4
  for (int j = 0; j < k_slice; ++j) {
    const uint2 wv = __ldg(wp + (size_t)j * row8);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int lo = nib_lo(wv, c), hi = nib_hi(wv, c);
#pragma unroll
      for (int r = 0; r < M; ++r) acc[r][c] += xs[0][r][j] * lo + xs[1][r][j] * hi;
    }
  }

  int* out = partial + ((size_t)blockIdx.y * m + row0) * n + col;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r < rows) {
      int4* o = reinterpret_cast<int4*>(out + (size_t)r * n);
      o[0] = make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      o[1] = make_int4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
}

// One thread per output: the slices of each tile add up exactly in int32,
// then acc + float(p) * x_scale * tile_scale in tile order. The loop runs
// over all slices flat, so its loads do not wait on the running sum and the
// unrolled body keeps several in flight.
template <typename T>
__global__ void rk_int4_a8_reduce_kernel(
    const int* __restrict__ partial, const float* __restrict__ x_scale,
    const float* __restrict__ gs, int m, int n, int slices, int slices_per_tile,
    T* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  const float xsc = x_scale[idx / n];
  const float* s = gs + idx % n;
  const int* src = partial + idx;
  const size_t stride = (size_t)m * n;
  float acc = 0.f;
  int p = 0, left = slices_per_tile;
#pragma unroll 8
  for (int j = 0; j < slices; ++j) {
    p += __ldg(src + (size_t)j * stride);
    if (--left == 0) {
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__int2float_rn(p), xsc), __ldg(s)));
      s += n;
      p = 0;
      left = slices_per_tile;
    }
  }
  out[idx] = from_f32<T>(acc);
}

dim3 partial_grid(int m, int k, int n, int k_slice) {
  return dim3((n + kColsPerBlock - 1) / kColsPerBlock, k / 2 / k_slice,
              (m + kRowGroup - 1) / kRowGroup);
}

bool bad_shape(int m, int k, int n, int tile_k, int k_slice) {
  return m < 1 || n % kColsPerBlock || tile_k % 2 || k % tile_k || k_slice < 1 ||
         k_slice > kMaxSlice || (tile_k / 2) % k_slice;
}

template <typename T, int M>
cudaError_t launch_w4a16_partial(const T* x, const uint2* w, const float* gs,
                                 int m, int k, int n, int tile_k, int group,
                                 int k_slice, float* partial, cudaStream_t s) {
  const dim3 grid = partial_grid(m, k, n, k_slice);
  if (group == tile_k)
    rk_int4_partial_kernel<T, M, true><<<grid, kThreads, 0, s>>>(
        x, w, gs, m, k, n, tile_k, group, k_slice, partial);
  else
    rk_int4_partial_kernel<T, M, false><<<grid, kThreads, 0, s>>>(
        x, w, gs, m, k, n, tile_k, group, k_slice, partial);
  return cudaGetLastError();
}

template <typename T>
int launch_w4a16(const void* xv, const int8_t* w_p, const float* gs, int m,
                 int k, int n, int tile_k, int group, int k_slice,
                 float* partial, void* outv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const uint2* w = reinterpret_cast<const uint2*>(w_p);
  cudaError_t err;
  if (m <= 1)
    err = launch_w4a16_partial<T, 1>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, s);
  else if (m <= 2)
    err = launch_w4a16_partial<T, 2>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, s);
  else if (m <= 4)
    err = launch_w4a16_partial<T, 4>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, s);
  else
    err = launch_w4a16_partial<T, 8>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, s);
  if (err != cudaSuccess) return (int)err;
  const int total = m * n;
  rk_int4_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, m, n, k / 2 / k_slice, static_cast<T*>(outv));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const void* xv, const int8_t* w_p, const float* gs, const int* ids,
                  int slots, int k, int n, int tile_k, int group, int k_slice,
                  float* partial, void* outv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const uint2* w = reinterpret_cast<const uint2*>(w_p);
  dim3 grid = partial_grid(slots, k, n, k_slice);
  grid.z = slots;  // one slot a block
  if (group == tile_k)
    rk_moe_gather_int4_partial_kernel<T, true><<<grid, kThreads, 0, s>>>(
        x, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial);
  else
    rk_moe_gather_int4_partial_kernel<T, false><<<grid, kThreads, 0, s>>>(
        x, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = slots * n;
  rk_moe_gather_int4_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, slots, n, k / 2 / k_slice, static_cast<T*>(outv));
  return (int)cudaGetLastError();
}

template <int M>
cudaError_t launch_a8_partial(const int8_t* xq, const uint2* w, int m, int k,
                              int n, int tile_k, int k_slice, int* partial,
                              cudaStream_t s) {
  rk_int4_a8_partial_kernel<M><<<partial_grid(m, k, n, k_slice), kThreads, 0, s>>>(
      xq, w, m, k, n, tile_k, k_slice, partial);
  return cudaGetLastError();
}

template <typename T>
int launch_w4a8(const void* xv, const int8_t* w_p, const float* gs, int m,
                int k, int n, int tile_k, int k_slice, int8_t* xq, float* xs,
                int* partial, void* outv, cudaStream_t s) {
  rk_quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(static_cast<const T*>(xv), k,
                                                        xq, xs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint2* w = reinterpret_cast<const uint2*>(w_p);
  if (m <= 1) err = launch_a8_partial<1>(xq, w, m, k, n, tile_k, k_slice, partial, s);
  else if (m <= 2) err = launch_a8_partial<2>(xq, w, m, k, n, tile_k, k_slice, partial, s);
  else if (m <= 4) err = launch_a8_partial<4>(xq, w, m, k, n, tile_k, k_slice, partial, s);
  else err = launch_a8_partial<8>(xq, w, m, k, n, tile_k, k_slice, partial, s);
  if (err != cudaSuccess) return (int)err;
  const int total = m * n;
  rk_int4_a8_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, xs, gs, m, n, k / 2 / k_slice, tile_k / 2 / k_slice,
      static_cast<T*>(outv));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// W4A16. x (m, k) in dtype (0 = float32, 1 = bfloat16); w_p (k/2, n) packed
// int8; gscale (k/group, n) f32 with group dividing tile_k; out (m, n) in
// x's dtype. n % 512 == 0, k % tile_k == 0, k_slice <= 256 divides
// tile_k/2; partial holds (k/2/k_slice) * m * n floats. Returns a
// cudaError_t.
int rk_int4_matmul(const void* x, const int8_t* w_p, const float* gscale,
                   int m, int k, int n, int tile_k, int group, int k_slice,
                   int dtype, float* partial, void* out, void* stream) {
  if (bad_shape(m, k, n, tile_k, k_slice) || group < 1 || tile_k % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_w4a16<__nv_bfloat16>(x, w_p, gscale, m, k, n, tile_k, group,
                                       k_slice, partial, out, s);
  return launch_w4a16<float>(x, w_p, gscale, m, k, n, tile_k, group, k_slice,
                             partial, out, s);
}

// Gather (#13): x (slots, k) in dtype; w_p (E, k/2, n) packed int8; gscale
// (E, k/group, n) f32 with group dividing tile_k; ids (slots,) int32; out
// (slots, n) in x's dtype. 1 <= slots <= 64, n % 256 == 0, k % tile_k == 0,
// k_slice <= 256 divides tile_k/2; partial holds (k/2/k_slice) * slots * n
// floats. Returns a cudaError_t.
int rk_moe_gather_int4(const void* x, const int8_t* w_p, const float* gscale,
                       const int* ids, int slots, int k, int n, int tile_k,
                       int group, int k_slice, int dtype, float* partial,
                       void* out, void* stream) {
  if (slots < 1 || slots > 64 || n % 256 || tile_k % 2 || k % tile_k || k_slice < 1 ||
      k_slice > kMaxSlice || (tile_k / 2) % k_slice || group < 1 || tile_k % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(x, w_p, gscale, ids, slots, k, n, tile_k, group,
                                        k_slice, partial, out, s);
  return launch_gather<float>(x, w_p, gscale, ids, slots, k, n, tile_k, group,
                              k_slice, partial, out, s);
}

// W4A8 (group == tile_k: gscale (k/tile_k, n)). Shapes as rk_int4_matmul;
// xq (m, k) int8 and x_scale (m,) f32 are scratch for the quantized rows;
// partial holds (k/2/k_slice) * m * n int32. Returns a cudaError_t.
int rk_int4_matmul_a8(const void* x, const int8_t* w_p, const float* gscale,
                      int m, int k, int n, int tile_k, int k_slice, int dtype,
                      int8_t* xq, float* x_scale, int* partial, void* out,
                      void* stream) {
  if (bad_shape(m, k, n, tile_k, k_slice)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_w4a8<__nv_bfloat16>(x, w_p, gscale, m, k, n, tile_k, k_slice,
                                      xq, x_scale, partial, out, s);
  return launch_w4a8<float>(x, w_p, gscale, m, k, n, tile_k, k_slice, xq,
                            x_scale, partial, out, s);
}

}  // extern "C"
