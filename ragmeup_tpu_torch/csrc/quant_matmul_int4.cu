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
// conversions and FMAs. W4A16 with m <= 8 takes the decode kernels
// (rk_int4_decode_mma_kernel, rk_int4_decode_kernel: their design is
// described above them, further down), W4A8 with m <= 8 the integer
// tensor-core kernel rk_int4_a8_decode_kernel on the same weight stream
// (last section), and the gather takes #4's where n % 512 == 0:
//
//   * The gather runs the decode kernels' bodies with one slot a block
//     along grid.z (kernels of its own names, so a trace tells #4 and #13
//     apart: rk_moe_gather_int4_mma_kernel for bf16 x whose groups the
//     tensor cores take, rk_moe_gather_int4_decode_kernel for f32 x and
//     the groups they refuse). The block reads its slot's expert id from
//     device memory (the TPU kernel's scalar prefetch, no host sync),
//     offsets the packed weights and the scales by it, stages its slot's x
//     row alone and writes row z of the output or of its slice's partial.
//     The slices are added in slice order by rk_moe_gather_int4_reduce_kernel
//     (no atomics). At Mixtral decode (2 slots) one layer's gate, up and
//     down are 176 MB of packed experts and 11 MB of group-128 scales:
//     0.056 ms at 3.35 TB/s, bound by those bytes; each routed expert's
//     bytes stream once per slot. The plan is the decode route's, with the
//     slots counted as blocks (ops/moe_matmul.py::int4_gather_plan).
//
// The design below is shared by the W4A16 and W4A8 kernels for m > 8 (and
// W4A8 tiles the integer kernel cannot cut into 16-row k-blocks) and the
// gather's shapes whose n the 512-column strips do not tile (n % 256 ==
// 0, rk_moe_gather_int4_partial_kernel):
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
//     256-row prefill buckets reach it too, at scalar-FMA speed. The gather
//     on this body takes one slot a block along grid.z, offset by its
//     expert as above.
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

#include "int4_decode_mma.cuh"

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

template <typename T>
int launch_w4a8(const void* xv, const int8_t* w_p, const float* gs, int m,
                int k, int n, int tile_k, int k_slice, int8_t* xq, float* xs,
                int* partial, void* outv, cudaStream_t s) {
  rk_quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(static_cast<const T*>(xv), k,
                                                        xq, xs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 8-row groups of x (m <= 8 reaches this kernel only at tiles the decode
  // kernel cannot cut into 16-row k-blocks)
  rk_int4_a8_partial_kernel<kRowGroup><<<partial_grid(m, k, n, k_slice), kThreads, 0, s>>>(
      xq, reinterpret_cast<const uint2*>(w_p), m, k, n, tile_k, k_slice, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = m * n;
  rk_int4_a8_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, xs, gs, m, n, k / 2 / k_slice, tile_k / 2 / k_slice,
      static_cast<T*>(outv));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W4A16 decode (m <= 8): rk_int4_decode_kernel (f32 x, and shapes whose
// scale groups the tensor-core kernel below cannot take) and
// rk_int4_decode_mma_kernel (bf16 x); the gather's
// rk_moe_gather_int4_decode_kernel and rk_moe_gather_int4_mma_kernel run
// the same bodies on one slot's x row and expert
// ---------------------------------------------------------------------------
//
// The same function as rk_int4_partial_kernel, on #3's weight stream
// (csrc/quant_matmul.cu) at half the bytes a column. Bound by the packed
// bytes (k * n / 2); what held the 64-thread kernel back was bytes in
// flight (8 a lane, about 1 KB a block) and the conversion unit (an I2F
// and an F2F per weight on the quality route: 4 a packed byte, against the
// 16 a clock an SM converts). Design:
//
//   * A block of 8 warps owns a strip of 512 columns and a slice of one
//     k-tile's packed rows; each warp walks a contiguous, even run of them.
//     A lane loads 16 adjacent columns of a packed row (32 weights: rows j
//     and j + tile_k/2) with one 16-byte ld.global.nc, and keeps two
//     register batches of rows in flight (8 rows for m <= 4, 4 at m = 8),
//     issuing the next batch's loads before it consumes the current one.
//   * Nibbles to numbers without the conversion unit: one PRMT puts
//     column c's byte of packed rows j and j + 1 side by side, and
//     nibbles_bf16x2 (a mask, a bias and one HSUB2) turns each nibble pair
//     into exact bf16 integers. Rows j and j + 1 share their scale groups (the
//     runs start at even rows and the groups are even), so on the quality
//     route with bf16 x, scale_pair takes both to f32(q) * scale rounded to
//     bf16 (the TPU kernel's rounding) with one packing conversion: one
//     conversion a packed byte. The bf16 pairs are widened to f32 by shift
//     and mask and FMA'd into f32 sums. f32 x scales in f32 and does not
//     round; the output-scaled route (group == tile_k) needs no conversion.
//   * x's slice is staged in shared memory as f32, each packed row's low-
//     and high-nibble x values side by side ([row][lo m | hi m]), so a pair
//     of rows is one to eight float4 broadcasts.
//   * The warps' sums are added in shared memory in warp order; on the
//     output-scaled route the block's sum is then scaled by its tile's
//     scale. The plan (ops/quant_matmul.py::int4_decode_plan) splits each
//     k-tile into slices where the strips alone leave SMs idle; each slice
//     writes an f32 partial, added in slice order by rk_int4_reduce_kernel
//     (no atomics). One slice writes the output directly.
//   * A warp's first batch of weights is requested before x is staged, so
//     the two loads' latencies overlap.

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecColsPerLane = 16;
constexpr int kDecColsPerBlock = 32 * kDecColsPerLane;   // 512
constexpr int kDecRedFloats = kDecWarps * kDecColsPerBlock;
constexpr int kDecXsFloats = 12288;                       // 48 KB of staged x

// x of packed rows j and j + 1: [lo of j (M) | hi of j (M) | lo of j + 1 | hi of j + 1]
template <int M>
__device__ __forceinline__ void x_pair(const float* xs, float (&xv)[4 * M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float4 v = reinterpret_cast<const float4*>(xs)[i];
    xv[4 * i] = v.x; xv[4 * i + 1] = v.y; xv[4 * i + 2] = v.z; xv[4 * i + 3] = v.w;
  }
}

// acc[r][c] += the 16 columns' four weights (low and high nibble of packed
// rows j and j + 1) times their x values
template <typename T, int M, bool kOutScaled>
__device__ __forceinline__ void consume_pair(const int4& wa, const int4& wb,
                                             const float* xs, const float (&slo)[16],
                                             const float (&shi)[16],
                                             float (&acc)[M][kDecColsPerLane]) {
  float xv[4 * M];
  x_pair<M>(xs, xv);
  const uint32_t a[4] = {(uint32_t)wa.x, (uint32_t)wa.y, (uint32_t)wa.z, (uint32_t)wa.w};
  const uint32_t b[4] = {(uint32_t)wb.x, (uint32_t)wb.y, (uint32_t)wb.z, (uint32_t)wb.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      const int c = 4 * q + byte;
      // byte `byte` of row j at bits 0-7, of row j + 1 at bits 16-23
      const uint32_t t = __byte_perm(a[q], b[q], byte | ((4 + byte) << 8));
      uint32_t lo = nibbles_bf16x2(t), hi = nibbles_bf16x2(t >> 4);
      constexpr bool kRound = !kOutScaled && sizeof(T) == 2;
      if constexpr (kRound) {
        lo = scale_pair(lo, slo[c]);
        hi = scale_pair(hi, shi[c]);
      }
      float la = __uint_as_float(lo << 16), lb = __uint_as_float(lo & 0xFFFF0000u);
      float ha = __uint_as_float(hi << 16), hb = __uint_as_float(hi & 0xFFFF0000u);
      if constexpr (!kOutScaled && !kRound) {
        la = __fmul_rn(la, slo[c]); lb = __fmul_rn(lb, slo[c]);
        ha = __fmul_rn(ha, shi[c]); hb = __fmul_rn(hb, shi[c]);
      }
#pragma unroll
      for (int r = 0; r < M; ++r) {
        float s = acc[r][c];
        s = fmaf(xv[r], la, s);
        s = fmaf(xv[M + r], ha, s);
        s = fmaf(xv[2 * M + r], lb, s);
        acc[r][c] = fmaf(xv[3 * M + r], hb, s);
      }
    }
  }
}

// The scalar kernel's body, shared by #4 and the gather: x's rows [0, m)
// (m <= M) against one weight matrix w / gs, for the block's strip and
// slice; x row r lands in row row0 + r of the output (rows_out rows) or of
// the block's slice of the partial.
template <typename T, int M, int kBatch, bool kOutScaled>
__device__ __forceinline__ void int4_decode_body(
    const T* __restrict__ x, int m, const int8_t* __restrict__ w,
    const float* __restrict__ gs, int k, int n, int tile_k, int group, int k_slice,
    int row0, int rows_out, float* __restrict__ partial, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int half = tile_k / 2;
  const int per_tile = (half + k_slice - 1) / k_slice;
  const int tile = blockIdx.y / per_tile;
  const int pr0 = (blockIdx.y - tile * per_tile) * k_slice;  // first packed row in the tile
  const int rows = min(k_slice, half - pr0);
  const int klo = tile * tile_k + pr0;                       // its low nibble's x column

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kDecColsPerBlock + lane * kDecColsPerLane;
  const int per_warp = ((rows + kDecWarps - 1) / kDecWarps + 1) & ~1;  // even: pairs
  const int j0 = min(rows, warp * per_warp);
  const int j1 = min(rows, j0 + per_warp);

  const int8_t* wp = w + ((size_t)tile * half + pr0) * n + col;
  int4 a[kBatch], b[kBatch];
  auto load = [&](int4 (&buf)[kBatch], int j) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      buf[u] = j + u < j1 ? ld_nc16(wp + (size_t)(j + u) * n) : make_int4(0, 0, 0, 0);
  };
  load(a, j0);  // in flight while x is staged

  float* xs = smem;  // [rows][lo M | hi M], then the warp sums
  for (int i = threadIdx.x; i < 2 * M * rows; i += kDecThreads) {
    const int r = i / (2 * rows), rem = i - r * 2 * rows;
    const int h = rem / rows, j = rem - h * rows;
    xs[j * 2 * M + h * M + r] = r < m ? to_f32(x[(size_t)r * k + klo + h * half + j]) : 0.f;
  }
  __syncthreads();

  float acc[M][kDecColsPerLane];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kDecColsPerLane; ++c) acc[r][c] = 0.f;

  // the scales of the current low- and high-nibble groups (quality route),
  // and the slice row at which each group ends
  float slo[16], shi[16];
  int lo_end = 0, hi_end = 0;
  const size_t gpt = (size_t)(tile_k / group);
  auto scales_for = [&](int j) {
    if (j >= lo_end) {
      const int g = (pr0 + j) / group;
      load_scales16(gs + ((size_t)tile * gpt + g) * n + col, slo);
      lo_end = (g + 1) * group - pr0;
    }
    if (j >= hi_end) {
      const int g = (half + pr0 + j) / group;
      load_scales16(gs + ((size_t)tile * gpt + g) * n + col, shi);
      hi_end = (g + 1) * group - half - pr0;
    }
  };

  auto use = [&](const int4 (&buf)[kBatch], int j) {
#pragma unroll
    for (int u = 0; u < kBatch; u += 2) {
      if (j + u < j1) {
        if constexpr (!kOutScaled) scales_for(j + u);
        consume_pair<T, M, kOutScaled>(buf[u], buf[u + 1], xs + (j + u) * 2 * M, slo, shi,
                                       acc);
      }
    }
  };
  for (int j = j0; j < j1; j += 2 * kBatch) {
    load(b, j + kBatch);       // in flight while `a` is consumed
    use(a, j);
    load(a, j + 2 * kBatch);   // in flight while `b` is consumed
    use(b, j + kBatch);
  }

  // add the warps' sums in warp order, one x row at a time
  float* red = smem;  // [kDecWarps][kDecColsPerBlock]
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= m) break;
    __syncthreads();   // x (first row) or the previous row's sums are read
    float4* dst = reinterpret_cast<float4*>(red + warp * kDecColsPerBlock +
                                            lane * kDecColsPerLane);
#pragma unroll
    for (int c = 0; c < kDecColsPerLane; c += 4)
      dst[c / 4] = make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    __syncthreads();
    for (int cc = threadIdx.x; cc < kDecColsPerBlock; cc += kDecThreads) {
      const int oc = blockIdx.x * kDecColsPerBlock + cc;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kDecWarps; ++wi) s += red[wi * kDecColsPerBlock + cc];
      if (kOutScaled) s = __fmul_rn(s, __ldg(gs + (size_t)tile * n + oc));  // group == tile_k
      if (direct)
        out[(size_t)(row0 + r) * n + oc] = from_f32<T>(s);
      else
        partial[((size_t)blockIdx.y * rows_out + row0 + r) * n + oc] = s;
    }
  }
}

template <typename T, int M, int kBatch, bool kOutScaled>
__global__ void __launch_bounds__(kDecThreads) rk_int4_decode_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ gs,
    int m, int k, int n, int tile_k, int group, int k_slice, float* __restrict__ partial,
    T* __restrict__ out) {
  int4_decode_body<T, M, kBatch, kOutScaled>(x, m, w, gs, k, n, tile_k, group, k_slice, 0,
                                             m, partial, out);
}

// The gather on the scalar kernel: slot z (grid.z) is one x row against
// expert ids[z], read from device memory (no host sync)
template <typename T, bool kOutScaled>
__global__ void __launch_bounds__(kDecThreads) rk_moe_gather_int4_decode_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ gs,
    const int* __restrict__ ids, int slots, int k, int n, int tile_k, int group,
    int k_slice, float* __restrict__ partial, T* __restrict__ out) {
  const int z = blockIdx.z;
  const size_t e = (size_t)ids[z];
  int4_decode_body<T, 1, 8, kOutScaled>(x + (size_t)z * k, 1, w + e * (k / 2) * n,
                                        gs + e * (k / group) * n, k, n, tile_k, group,
                                        k_slice, z, slots, partial, out);
}

// bf16 x: the products on the tensor cores (rk_int4_decode_mma_kernel).
// The scalar kernel above spends about 12 instructions a packed byte at
// m = 1, 4 of them widening the bf16 weights back to f32 and FMAs; here
// the bf16 pairs that nibbles_bf16x2 / scale_pair produce are already
// mma.sync fragments, so those go, and m = 8 costs what m = 1 does:
//
//   * A block of 4 warps owns the 512-column strip, a warp 128 columns
//     over the whole slice (no sums across warps). Lane (g, c) = (lane / 4,
//     lane % 4) loads columns 16 g .. 16 g + 15 of its warp's quarter from
//     packed rows j + c and j + c + 4 of each 8-row k-block (a warp's load
//     reads four rows' 128 contiguous bytes), and keeps the next k-block's
//     loads in flight while it uses the current one. (Measured on the
//     card: two k-blocks a batch, or a cp.async ring of 4-8 k-blocks in
//     shared memory, were slower: the kernel waits on its instructions,
//     not on memory.)
//   * The weights are the A operand (16 columns x 16 k a mma), x the B
//     operand (16 k x 8 x rows: m <= 8 fills it). mma i (0..7) of a
//     k-block takes from lane (g, c) its columns i (A row g) and 8 + i
//     (A row g + 8): A columns 2c, 2c + 1 are the low nibbles of packed
//     rows j + c, j + c + 4 (one PRMT + nibbles_bf16x2), 2c + 8, 2c + 9
//     their high nibbles; on the quality route scale_pair scales each pair
//     (one group: k-blocks are 8-row aligned and groups a multiple of 8).
//     x is staged once per block in shared memory as bf16 in the same k
//     order (exact: x is bf16), one 8-byte B fragment a lane a k-block.
//   * Lane (g, c) ends with x rows 2c and 2c + 1 of its 16 columns,
//     scaled by the tile's scale on the output-scaled route and written as
//     the slice's partial (one slice: the output).
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

// The tensor-core kernel's body, shared by #4 and the gather; arguments as
// int4_decode_body's (m <= 8). The stream itself (int4_mma_stream,
// int4_decode_mma.cuh) is shared with #6's fused MLP too.
template <bool kOutScaled>
__device__ __forceinline__ void int4_decode_mma_body(
    const __nv_bfloat16* __restrict__ x, int m, const int8_t* __restrict__ w,
    const float* __restrict__ gs, int k, int n, int tile_k, int group, int k_slice,
    int row0, int rows_out, float* __restrict__ partial, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t xa[];  // [k-block][x row][c][b0, b1]
  const int half = tile_k / 2;
  const MmaSlice sl(tile_k, k_slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int col = blockIdx.x * kDecColsPerBlock + warp * 128 + g * 16;
  const int8_t* wp = w + ((size_t)sl.tile * half + sl.pr0 + c) * n + col;
  KBlock A;
  mma_load(A, wp, n, 0, sl.kblocks);  // in flight while x is staged

  // in the k order of int4_decode_mma.cuh
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xa);
  for (int i = threadIdx.x; i < sl.kblocks * 128; i += kMmaThreads) {
    const int kb = i / 128, r = (i / 16) % 8, p = i % 16;
    const int j = 8 * kb + p / 4 + 4 * (p % 2);
    xs[i] = r < m ? x[(size_t)r * k + sl.klo + ((p / 2) % 2) * half + j]
                  : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  float d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
  int4_mma_stream<kOutScaled>(xa, m, wp, gs + (size_t)sl.tile * (tile_k / group) * n + col, n,
                              half, sl.pr0, group, sl.kblocks, A, d);

  float v[2][16];
  mma_rows(d, v);
  if (kOutScaled) {  // group == tile_k
    float sc[16];
    load_scales16(gs + (size_t)sl.tile * n + col, sc);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[0][i] = __fmul_rn(v[0][i], sc[i]);
      v[1][i] = __fmul_rn(v[1][i], sc[i]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 2 * c + h;
    if (r >= m) break;
    if (gridDim.y == 1) {
      uint4* o = reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * n + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        o[i] = make_uint4(pack_bf16x2(v[h][8 * i], v[h][8 * i + 1]),
                          pack_bf16x2(v[h][8 * i + 2], v[h][8 * i + 3]),
                          pack_bf16x2(v[h][8 * i + 4], v[h][8 * i + 5]),
                          pack_bf16x2(v[h][8 * i + 6], v[h][8 * i + 7]));
    } else {
      float4* o = reinterpret_cast<float4*>(
          partial + ((size_t)blockIdx.y * rows_out + row0 + r) * n + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = make_float4(v[h][4 * i], v[h][4 * i + 1], v[h][4 * i + 2], v[h][4 * i + 3]);
    }
  }
}

template <bool kOutScaled>
__global__ void __launch_bounds__(kMmaThreads) rk_int4_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ gs, int m, int k, int n, int tile_k, int group, int k_slice,
    float* __restrict__ partial, __nv_bfloat16* __restrict__ out) {
  int4_decode_mma_body<kOutScaled>(x, m, w, gs, k, n, tile_k, group, k_slice, 0, m, partial,
                                   out);
}

// The gather on the tensor cores: slot z (grid.z) is one x row (B column
// 0 of each mma, whose lanes g = 0 carry it) against expert ids[z]; its
// sums land in row z
template <bool kOutScaled>
__global__ void __launch_bounds__(kMmaThreads) rk_moe_gather_int4_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ gs, const int* __restrict__ ids, int slots, int k, int n,
    int tile_k, int group, int k_slice, float* __restrict__ partial,
    __nv_bfloat16* __restrict__ out) {
  const int z = blockIdx.z;
  const size_t e = (size_t)ids[z];
  int4_decode_mma_body<kOutScaled>(x + (size_t)z * k, 1, w + e * (k / 2) * n,
                                   gs + e * (k / group) * n, k, n, tile_k, group, k_slice, z,
                                   slots, partial, out);
}

template <typename T, int M, int kBatch>
cudaError_t launch_decode_slices(const T* x, const int8_t* w, const float* gs, int m,
                                 int k, int n, int tile_k, int group, int k_slice,
                                 float* partial, T* out, cudaStream_t s) {
  if (2 * M * k_slice > kDecXsFloats) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)max(2 * M * k_slice, kDecRedFloats) * sizeof(float);
  const dim3 grid(n / kDecColsPerBlock, decode_slices(k, tile_k, k_slice));
  if (group == tile_k)
    rk_int4_decode_kernel<T, M, kBatch, true><<<grid, kDecThreads, bytes, s>>>(
        x, w, gs, m, k, n, tile_k, group, k_slice, partial, out);
  else
    rk_int4_decode_kernel<T, M, kBatch, false><<<grid, kDecThreads, bytes, s>>>(
        x, w, gs, m, k, n, tile_k, group, k_slice, partial, out);
  return cudaGetLastError();
}

template <typename T>
int launch_w4a16_decode(const void* xv, const int8_t* w, const float* gs, int m, int k,
                        int n, int tile_k, int group, int k_slice, bool tensor_cores,
                        float* partial, void* outv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  cudaError_t err;
  if (tensor_cores) {
    const dim3 grid(n / kDecColsPerBlock, decode_slices(k, tile_k, k_slice));
    const size_t bytes = (size_t)32 * k_slice;
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(out);
    if (group == tile_k)
      rk_int4_decode_mma_kernel<true><<<grid, kMmaThreads, bytes, s>>>(
          xb, w, gs, m, k, n, tile_k, group, k_slice, partial, ob);
    else
      rk_int4_decode_mma_kernel<false><<<grid, kMmaThreads, bytes, s>>>(
          xb, w, gs, m, k, n, tile_k, group, k_slice, partial, ob);
    err = cudaGetLastError();
  } else if (m <= 1)
    err = launch_decode_slices<T, 1, 8>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, out, s);
  else if (m <= 2)
    err = launch_decode_slices<T, 2, 8>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, out, s);
  else if (m <= 4)
    err = launch_decode_slices<T, 4, 8>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, out, s);
  else
    err = launch_decode_slices<T, 8, 4>(x, w, gs, m, k, n, tile_k, group, k_slice, partial, out, s);
  if (err != cudaSuccess) return (int)err;
  const int splits = decode_slices(k, tile_k, k_slice);
  if (splits > 1) {
    const int total = m * n;
    rk_int4_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(partial, m, n, splits, out);
  }
  return (int)cudaGetLastError();
}

// the gather on the decode kernels: grid (strips, slices, slots)
template <typename T>
int launch_gather_decode(const void* xv, const int8_t* w, const float* gs, const int* ids,
                         int slots, int k, int n, int tile_k, int group, int k_slice,
                         bool tensor_cores, float* partial, void* outv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int splits = decode_slices(k, tile_k, k_slice);
  const dim3 grid(n / kDecColsPerBlock, splits, slots);
  if (tensor_cores) {
    const size_t bytes = (size_t)32 * k_slice;
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(out);
    if (group == tile_k)
      rk_moe_gather_int4_mma_kernel<true><<<grid, kMmaThreads, bytes, s>>>(
          xb, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial, ob);
    else
      rk_moe_gather_int4_mma_kernel<false><<<grid, kMmaThreads, bytes, s>>>(
          xb, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial, ob);
  } else {
    if (2 * k_slice > kDecXsFloats) return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)max(2 * k_slice, kDecRedFloats) * sizeof(float);
    if (group == tile_k)
      rk_moe_gather_int4_decode_kernel<T, true><<<grid, kDecThreads, bytes, s>>>(
          x, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial, out);
    else
      rk_moe_gather_int4_decode_kernel<T, false><<<grid, kDecThreads, bytes, s>>>(
          x, w, gs, ids, slots, k, n, tile_k, group, k_slice, partial, out);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int total = slots * n;
    rk_moe_gather_int4_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
        partial, slots, n, splits, out);
  }
  return (int)cudaGetLastError();
}

// shapes the decode kernels refuse (rk_int4_decode, rk_moe_gather_int4_decode)
bool bad_decode_shape(int k, int n, int tile_k, int group, int k_slice, int dtype,
                      int tensor_cores) {
  return n < kDecColsPerBlock || n % kDecColsPerBlock || tile_k < 4 || tile_k % 4 ||
         k < tile_k || k % tile_k || group < 1 || tile_k % group ||
         (group != tile_k && group % 2) || k_slice < 2 || k_slice % 2 ||
         k_slice > tile_k / 2 ||
         (tensor_cores && (dtype != 1 || !mma_takes(tile_k, group, k_slice)));
}

// ---------------------------------------------------------------------------
// W4A8 decode (m <= 8): rk_int4_a8_decode_kernel, the products on the
// integer tensor cores
// ---------------------------------------------------------------------------
//
// Replaces ragmeup_tpu/ops/quant_matmul.py::_kernel4_a8 at decode. The
// same function as rk_int4_a8_partial_kernel: rk_quantize_rows_kernel
// gives x's int8 codes and row scales (its rounding is the contract), each
// slice sums x_code * q exactly in int32, and rk_int4_a8_reduce_kernel adds
// each tile's slices, then acc + float(p) * x_scale * tile_scale over the
// tiles in order. Bound by the packed bytes (k * n / 2), as #4. What held
// the 64-thread kernel back was bytes in flight (8 a lane, about 1 KB a
// block) and 8 scalar integer multiply-adds a weight per x row. Design, on
// #4's weight stream (int4_decode_mma_body):
//
//   * A block of 4 warps owns a 512-column strip and a slice of one
//     k-tile's packed rows, a warp 128 columns over the whole slice (no
//     sums across warps). Lane (g, c) = (lane / 4, lane % 4) loads columns
//     16 g .. 16 g + 15 of its warp's quarter from packed rows
//     a8_kblock_row(c, 0..3) of each 16-row k-block, one 16-byte
//     ld.global.nc a row (a warp's load reads four rows' 128 contiguous
//     bytes), and keeps the next k-block's loads in flight while it uses
//     the current one; the first k-block is requested before x is staged.
//   * The products are mma.sync m16n8k32 s8 (mma_s8): the weights are the A
//     operand (16 columns x 32 k: a k-block's low and high nibbles), x's
//     codes the B operand (32 k x 8 x rows: m <= 8 fills it). mma i (0..7)
//     of a k-block takes from lane (g, c) its columns i (A row g) and 8 + i
//     (A row g + 8); k position 4c + e is the low nibble of packed row
//     a8_kblock_row(c, e), 16 + 4c + e its high nibble.
//   * Nibbles to int8 without the conversion unit: 4x4 byte transposes
//     (8 PRMT for 4 columns of 4 rows, 32 a k-block) put column j's byte
//     of the lane's four rows into one word t; t & 0xF0F0F0F0 is then the four high
//     nibbles as int8 16 q exactly (q in [-8, 7]), and (t << 4) &
//     0xF0F0F0F0 the four low nibbles. Every term is a multiple of 16, so
//     each sum is 16 p, exact: a slice has at most 2 * 3072 k terms (the
//     entry refuses longer slices), |16 p| <= 6144 * 128 * 127 < 2^31, and
//     p = sum >> 4.
//   * x's codes are staged once per block in shared memory in the mma's k
//     order, one 8-byte B fragment a lane a k-block (16 bytes a packed row:
//     8 x rows, low and high nibble; rows at or above m are zero).
//   * Lane (g, c) ends with x rows 2c and 2c + 1 of its 16 columns and
//     writes them as the slice's int32 partial. The plan
//     (ops/quant_matmul.py::int4_a8_decode_plan) cuts each k-tile into
//     slices of whole k-blocks (the last of a tile may be shorter); the
//     reduce adds them in slice order (no atomics).
constexpr int kA8KBlock = 16;                   // packed rows a k-block: 32 k an mma
constexpr int kA8MaxXsBytes = 48 * 1024;        // 16 bytes of staged x codes a packed row
// k-blocks a lane has loaded or in flight (measured on the card: 3, 4 and 6
// were no faster; the layer's 21 launches, not the stream, set its time)
constexpr int kA8Depth = 2;

// the packed row of a k-block that lane (., c) loads e-th (0..3): its low
// nibble is the mma's k position 4c + e, its high nibble 16 + 4c + e
// (ops/quant_matmul.py::int4_a8_kblock_order). Rows e = 0..3 of a lane are
// adjacent, so one 4-byte load stages their x codes.
__device__ __forceinline__ int a8_kblock_row(int c, int e) { return 4 * c + e; }

struct A8KBlock {
  int4 r[4];                                    // the lane's 16 bytes of rows a8_kblock_row(c, e)
};

// t[b] = byte b of w0..w3, lowest first: column b of four packed rows
__device__ __forceinline__ void transpose_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, uint32_t (&t)[4]) {
  const uint32_t p0 = __byte_perm(w0, w1, 0x5140), p1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t q0 = __byte_perm(w2, w3, 0x5140), q1 = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(p0, q0, 0x5410);
  t[1] = __byte_perm(p0, q0, 0x7632);
  t[2] = __byte_perm(p1, q1, 0x5410);
  t[3] = __byte_perm(p1, q1, 0x7632);
}

__global__ void __launch_bounds__(kMmaThreads) rk_int4_a8_decode_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w, int m, int k, int n,
    int tile_k, int k_slice, int* __restrict__ partial) {
  extern __shared__ __align__(16) uint32_t xa[];  // [k-block][x row][c][lo, hi]
  const int half = tile_k / 2;
  const int per_tile = (half + k_slice - 1) / k_slice;
  const int tile = blockIdx.y / per_tile;
  const int pr0 = (blockIdx.y - tile * per_tile) * k_slice;
  const int kblocks = min(k_slice, half - pr0) / kA8KBlock;
  const int klo = tile * tile_k + pr0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int col = blockIdx.x * kDecColsPerBlock + warp * 128 + g * 16;
  const int8_t* wp = w + ((size_t)tile * half + pr0) * n + col;

  auto load = [&](A8KBlock& bt, int kb) {
    const bool in = kb < kblocks;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t* p = wp + (size_t)(kA8KBlock * kb + a8_kblock_row(c, e)) * n;
      bt.r[e] = in ? ld_nc16(p) : make_int4(0, 0, 0, 0);
    }
  };
  A8KBlock buf[kA8Depth];  // buffer u holds the k-blocks kb = u (mod kA8Depth)
#pragma unroll
  for (int u = 0; u + 1 < kA8Depth; ++u) load(buf[u], u);  // in flight while x is staged

  // word ((kb * 8 + r) * 4 + c') * 2 + h: x row r's codes at k positions
  // 16 h + 4 c' .. + 3 of k-block kb
  for (int i = threadIdx.x; i < kblocks * 64; i += kMmaThreads) {
    const int kb = i / 64, r = (i / 8) % 8, cc = (i / 2) % 4, h = i % 2;
    xa[i] = r < m ? *reinterpret_cast<const uint32_t*>(
                        xq + (size_t)r * k + klo + h * half + kA8KBlock * kb + a8_kblock_row(cc, 0))
                  : 0u;
  }
  __syncthreads();

  int d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0;

  auto use = [&](const A8KBlock& bt, int kb) {
    if (kb >= kblocks) return;
    const uint2 xb = reinterpret_cast<const uint2*>(xa)[(kb * 8 + g) * 4 + c];
    const uint32_t r0[4] = {(uint32_t)bt.r[0].x, (uint32_t)bt.r[0].y, (uint32_t)bt.r[0].z,
                            (uint32_t)bt.r[0].w};
    const uint32_t r1[4] = {(uint32_t)bt.r[1].x, (uint32_t)bt.r[1].y, (uint32_t)bt.r[1].z,
                            (uint32_t)bt.r[1].w};
    const uint32_t r2[4] = {(uint32_t)bt.r[2].x, (uint32_t)bt.r[2].y, (uint32_t)bt.r[2].z,
                            (uint32_t)bt.r[2].w};
    const uint32_t r3[4] = {(uint32_t)bt.r[3].x, (uint32_t)bt.r[3].y, (uint32_t)bt.r[3].z,
                            (uint32_t)bt.r[3].w};
    uint32_t lo[16], hi[16];  // column j's four rows: low / high nibbles as 16 q
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t t[4];
      transpose_bytes(r0[q], r1[q], r2[q], r3[q], t);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        hi[4 * q + b] = t[b] & 0xF0F0F0F0u;
        lo[4 * q + b] = (t[b] << 4) & 0xF0F0F0F0u;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t a[4] = {lo[i], lo[8 + i], hi[i], hi[8 + i]};
      mma_s8(d[i], a, xb.x, xb.y);
    }
  };
  for (int kb = 0; kb < kblocks; kb += kA8Depth) {
#pragma unroll
    for (int u = 0; u < kA8Depth; ++u) {
      // the k-block kA8Depth - 1 ahead, into the buffer used last
      load(buf[(u + kA8Depth - 1) % kA8Depth], kb + u + kA8Depth - 1);
      use(buf[u], kb + u);
    }
  }

  // x rows 2c and 2c + 1: d[i][h] is column i, d[i][2 + h] column 8 + i of
  // the lane's 16; each sum is 16 p
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 2 * c + h;
    if (r >= m) break;
    int4* o = reinterpret_cast<int4*>(partial + ((size_t)blockIdx.y * m + r) * n + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * (i % 2), e = h + 2 * (i / 2);
      o[i] = make_int4(d[j][e] >> 4, d[j + 1][e] >> 4, d[j + 2][e] >> 4, d[j + 3][e] >> 4);
    }
  }
}

// shapes rk_int4_a8_decode refuses: whole 16-row k-blocks in each half
// tile, a slice of whole k-blocks within it and x's staging buffer
bool bad_a8_decode_shape(int m, int k, int n, int tile_k, int k_slice) {
  return m < 1 || m > 8 || n < kDecColsPerBlock || n % kDecColsPerBlock || tile_k < 32 ||
         tile_k % 32 || k < tile_k || k % tile_k || k_slice < kA8KBlock ||
         k_slice % kA8KBlock || k_slice > tile_k / 2 || 16 * k_slice > kA8MaxXsBytes;
}

template <typename T>
int launch_w4a8_decode(const void* xv, const int8_t* w, const float* gs, int m, int k,
                       int n, int tile_k, int k_slice, int8_t* xq, float* xs, int* partial,
                       void* outv, cudaStream_t s) {
  rk_quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(static_cast<const T*>(xv), k, xq,
                                                        xs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slices = decode_slices(k, tile_k, k_slice);
  const dim3 grid(n / kDecColsPerBlock, slices);
  rk_int4_a8_decode_kernel<<<grid, kMmaThreads, (size_t)16 * k_slice, s>>>(
      xq, w, m, k, n, tile_k, k_slice, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = m * n;
  rk_int4_a8_reduce_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, xs, gs, m, n, slices, (tile_k / 2 + k_slice - 1) / k_slice,
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

// W4A16 decode: shapes and dtypes as rk_int4_matmul, with 1 <= m <= 8,
// tile_k % 4 == 0 and an even group (or group == tile_k); k_slice even,
// at most tile_k/2, with 2 * k_slice * (m rounded up to 1, 2, 4 or 8) <=
// 12288. Each k-tile is cut into ceil(tile_k/2 / k_slice) slices of
// k_slice packed rows (the last may be shorter); partial holds
// (k/tile_k) * ceil(tile_k/2 / k_slice) * m * n floats when there is more
// than one slice. tensor_cores = 1 takes rk_int4_decode_mma_kernel (bf16
// x; tile_k % 16 == 0, group % 8 == 0 or group == tile_k, k_slice % 8 ==
// 0 and 32 * k_slice <= 49152), 0 the scalar kernel. Returns a cudaError_t.
int rk_int4_decode(const void* x, const int8_t* w_p, const float* gscale, int m,
                   int k, int n, int tile_k, int group, int k_slice, int dtype,
                   int tensor_cores, float* partial, void* out, void* stream) {
  if (m < 1 || m > 8 || bad_decode_shape(k, n, tile_k, group, k_slice, dtype, tensor_cores))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_w4a16_decode<__nv_bfloat16>(x, w_p, gscale, m, k, n, tile_k, group,
                                              k_slice, tensor_cores, partial, out, s);
  return launch_w4a16_decode<float>(x, w_p, gscale, m, k, n, tile_k, group, k_slice, false,
                                    partial, out, s);
}

// Gather (#13) on the decode kernels: x (slots, k), w_p (E, k/2, n),
// gscale (E, k/group, n), ids (slots,) int32 and out (slots, n) as
// rk_moe_gather_int4; the shapes rk_int4_decode takes, with 1 <= slots <=
// 64 in place of m and 2 * k_slice <= 12288 on the scalar kernel. partial
// holds (k/tile_k) * ceil(tile_k/2 / k_slice) * slots * n floats when there
// is more than one slice. tensor_cores = 1 takes
// rk_moe_gather_int4_mma_kernel (bf16 x), 0 rk_moe_gather_int4_decode_kernel.
// Returns a cudaError_t.
int rk_moe_gather_int4_decode(const void* x, const int8_t* w_p, const float* gscale,
                              const int* ids, int slots, int k, int n, int tile_k, int group,
                              int k_slice, int dtype, int tensor_cores, float* partial,
                              void* out, void* stream) {
  if (slots < 1 || slots > 64 ||
      bad_decode_shape(k, n, tile_k, group, k_slice, dtype, tensor_cores))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_gather_decode<__nv_bfloat16>(x, w_p, gscale, ids, slots, k, n, tile_k,
                                               group, k_slice, tensor_cores, partial, out, s);
  return launch_gather_decode<float>(x, w_p, gscale, ids, slots, k, n, tile_k, group, k_slice,
                                     false, partial, out, s);
}

// W4A8 decode: x (m, k) in dtype, 1 <= m <= 8; w_p (k/2, n) packed int8;
// gscale (k/tile_k, n) f32; n % 512 == 0, tile_k % 32 == 0, k % tile_k ==
// 0; k_slice a multiple of 16, at most tile_k/2 and 3072. Each k-tile is cut
// into ceil(tile_k/2 / k_slice) slices of k_slice packed rows (the last may
// be shorter); xq (m, k) int8 and x_scale (m,) f32 are scratch for the
// quantized rows, partial holds (k/tile_k) * ceil(tile_k/2 / k_slice) * m *
// n int32. Returns a cudaError_t.
int rk_int4_a8_decode(const void* x, const int8_t* w_p, const float* gscale, int m, int k,
                      int n, int tile_k, int k_slice, int dtype, int8_t* xq,
                      float* x_scale, int* partial, void* out, void* stream) {
  if (bad_a8_decode_shape(m, k, n, tile_k, k_slice)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_w4a8_decode<__nv_bfloat16>(x, w_p, gscale, m, k, n, tile_k, k_slice, xq,
                                             x_scale, partial, out, s);
  return launch_w4a8_decode<float>(x, w_p, gscale, m, k, n, tile_k, k_slice, xq, x_scale,
                                   partial, out, s);
}

// W4A8's first kernel alone (rk_quantize_rows_kernel): x (m, k) in dtype ->
// xq (m, k) int8 and x_scale (m,) f32. Returns a cudaError_t.
int rk_quantize_rows(const void* x, int m, int k, int dtype, int8_t* xq, float* x_scale,
                     void* stream) {
  if (m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    rk_quantize_rows_kernel<__nv_bfloat16><<<m, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), k, xq, x_scale);
  else
    rk_quantize_rows_kernel<float><<<m, kQuantThreads, 0, s>>>(static_cast<const float*>(x), k,
                                                               xq, x_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
