// Sparse-MoE expert matmuls for Hopper (sm_90a), over stacked experts
// w (E, k, n): int8 with per-expert per-output-channel scales (E, n), or
// bf16 / f32 with no scale. Each weight is cast to x's dtype before the
// product, products and sums are f32, the scale multiplies the sum, and the
// result rounds once to x's dtype (0 = float32, 1 = bfloat16). Sums are
// deterministic (no float atomics): a greedy decode repeats bit for bit.
//
// rk_moe_gather replaces the Pallas kernel
// ragmeup_tpu/ops/moe_matmul.py::_kernel: out[s] = x[s] @ w[ids[s]] for at
// most 64 slots. At decode it is bound by reading the routed experts' bytes
// once (Mixtral: 2 slots x 3 projections, 352 MB of int8 a layer, 0.105 ms
// at 3.35 TB/s); at Qwen3-30B-A3B's 768-wide experts a layer moves 38 MB
// and its launches, not its bytes, set the time. bf16 x runs
// rk_moe_gather_stream_kernel, quant_matmul.cu's stream with a grid axis
// for the slot: a block reads its slot's expert id on the device (the TPU
// kernel's scalar prefetch) and offsets the weights and scales by it; each
// lane loads 16 bytes of a row (16 int8, 8 bf16 or 4 f32 columns; a warp
// reads 512 contiguous bytes), two register batches of 4 rows in flight
// (128 bytes a lane, 76 registers: three blocks fit an SM; batches of 8
// measured slower at most slice lengths); int8 -> f32 by one PRMT and one
// FADD (i8_at), off the
// conversion unit; the 8 warps walk contiguous runs of the block's k slice
// and add their sums in shared memory in warp order. The last strip of a
// width that 512 columns do not divide (Qwen3's 768) runs with its lanes
// past n idle. Split-K across blocks (ops/moe_matmul.py gather_plan: as
// few slices as give every SM two blocks, each a whole number of the
// warps' double-buffered iterations; Mixtral's 2 slots cut gate and up in
// 5, down in 16): each slice writes an f32 partial, and the last block
// of a (slot, strip) to finish adds the slices in slice order, scales and
// rounds: one launch a call, where the first design made two. Measured
// against a stream-only copy of the first design's loads, the Mixtral
// layer is bound by its three launches' ramps and tails as much as by its
// bytes (tools/moe_times.py --stream). f32 x keeps the first design:
// rk_moe_gather_partial_kernel (4 columns a lane) and a reduce launch.
//
// rk_moe_grouped_rows replaces ragmeup_tpu/ops/moe_matmul.py::_grouped_kernel
// on the dedup route (#11, batched decode: 9-32 rows sorted by expert over
// Mixtral's 8 experts), and serves every other grouped call with bf16 rows
// that csrc/moe_stack.cu does not take. It reads the sorted rows and the
// group sizes gsz where they lie, with no padded copy: block (strip, slice,
// expert e) sums gsz[0..e) itself for its group's first row, exits at once
// for an empty group, and writes its outputs in sorted-row order. What
// bounds it: the routed experts' bytes (a Mixtral layer at groups [3, 2, 0,
// 4, 1, 2, 3, 1]: 1.23 GB of int8, 0.369 ms at 3.35 TB/s); the tensor work
// of 1-16 rows an expert is small beside it. What the design does about it:
//   - int8 -> bf16 off the conversion unit: a PRMT pairs two k rows' bytes
//     of two adjacent columns, and s8x2_bf16x2 (two LOP3s and one bf16
//     subtraction, exact) makes each column's k pair, straight into the
//     mma.sync A fragment in registers; bf16 weights are paired by PRMT
//     alone, f32 ones rounded by one F2FP a pair. No shared-memory round
//     trip for the weights.
//   - The product is transposed, out^T = W^T x^T, on mma.sync m16n8k16:
//     the 16 columns a lane group holds are the 16-row operand and 8 of
//     the group's rows the 8-wide one, so a group of 1-8 rows pads to 8.
//     Lane 4g + c loads k rows 4c .. 4c + 3 of a 16-deep step at its 16
//     bytes of columns (a warp reads 4 x 128 contiguous bytes a row set);
//     MMA k positions 2c, 2c + 1, 2c + 8, 2c + 9 stand for those rows, and
//     x's B fragment is one 8-byte load of the same 4 k values of a row.
//   - Each expert's bytes are streamed once per (strip, slice): one block
//     walks all of its group's 8-row tiles, 16 rows (two tiles of sums in
//     registers) a pass; a group longer than 16 rows (no Mixtral decode
//     group: at most 16 tokens) reads its slice again a pass.
//   - Bytes in flight: a register double buffer of two steps (128 bytes of
//     weights a lane), the 8 warps of a block on interleaved steps of its
//     k slice, up to two blocks an SM (125 registers): 64 KB a SM.
//   - Split-K (ops/moe_matmul.py grouped_rows_plan): slices of whole steps
//     only where the (strip, expert) blocks would not give every SM one
//     (a Mixtral layer's 8 x 112 and 8 x 32 do; fewer, longer slices
//     measured faster). The slices' f32 partials are added in slice order
//     by the last block of each (expert, strip), elected by an atomic
//     ticket: one launch a call, the last block reading 16 rows x 128
//     columns a slice at most.
// f32 x keeps the padded layout (ops/moe_matmul.py scatter_layout) and
// rk_moe_grouped_f32_kernel: f32 FMAs, since a tensor-core product would
// round the rows.
//
// Ticket words: the wrapper takes them from kernels.ticket_words, a zeroed
// buffer per (device, stream), and the last block of a strip sets its word
// back to zero, so every launch and every CUDA-graph replay finds them
// zero; calls on one stream run in order, so no two launches share a word
// at once, and no memset launch is needed (quant_matmul.cu's reason for a
// second launch does not hold once the words live per stream).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// gather, bf16 x: grid (column strips, k slices, slots)
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherBatch = 4;         // rows a register batch
constexpr int kGatherXsFloats = 12288;  // 48 KB of staged x

__device__ __forceinline__ uint32_t word(const int4& v, int q) {
  return (uint32_t)(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
}

// the 16 bytes of one row, cast to bf16, as floats
__device__ __forceinline__ void row16(const int4& v, const int8_t*, float (&f)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t u = word(v, q) ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) f[4 * q + b] = i8_at(u, b);
  }
}
__device__ __forceinline__ void row16(const int4& v, const __nv_bfloat16*, float (&f)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(word(v, q) << 16);
    f[2 * q + 1] = __uint_as_float(word(v, q) & 0xffff0000u);
  }
}
__device__ __forceinline__ void row16(const int4& v, const float*, float (&f)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] = round_to<__nv_bfloat16>(__uint_as_float(word(v, q)));
}

__device__ __forceinline__ float scaled(float v, const float* srow, int col) {
  return srow != nullptr ? v * srow[col] : v;
}

template <typename W>
__global__ void __launch_bounds__(kGatherThreads) rk_moe_gather_stream_kernel(
    const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ ids, int slots, int k, int n,
    int k_slice, float* __restrict__ partial, unsigned* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out) {
  constexpr int kCols = 16 / (int)sizeof(W);   // a lane's columns
  constexpr int kStrip = 32 * kCols;           // a block's columns
  extern __shared__ __align__(16) float smem[];  // x's slice, then the warp sums
  __shared__ int last;
  const int s = blockIdx.z;
  const int k0 = blockIdx.y * k_slice;
  const int rows = min(k_slice, k - k0);
  for (int j = threadIdx.x; j < rows; j += kGatherThreads)
    smem[j] = __bfloat162float(x[(size_t)s * k + k0 + j]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kStrip + lane * kCols;
  const int per_warp = (rows + kGatherWarps - 1) / kGatherWarps;
  const int j0 = min(rows, warp * per_warp);
  const int j1 = min(rows, j0 + per_warp);
  const size_t e = (size_t)ids[s];

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  if (col < n) {
    const W* wp = w + (e * k + k0) * n + col;
    int4 a[kGatherBatch], b[kGatherBatch];
    auto load = [&](int4 (&buf)[kGatherBatch], int j) {
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u)
        buf[u] = j + u < j1 ? ld_nc16(wp + (size_t)(j + u) * n) : make_int4(0, 0, 0, 0);
    };
    auto use = [&](const int4 (&buf)[kGatherBatch], int j) {
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        if (j + u >= j1) break;
        float f[kCols];
        row16(buf[u], wp, f);
        const float xv = smem[j + u];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(xv, f[c], acc[c]);
      }
    };
    load(a, j0);
    for (int j = j0; j < j1; j += 2 * kGatherBatch) {
      load(b, j + kGatherBatch);       // in flight while `a` is consumed
      use(a, j);
      load(a, j + 2 * kGatherBatch);   // in flight while `b` is consumed
      use(b, j + kGatherBatch);
    }
  }

  // the warps' sums in warp order
  __syncthreads();   // x's slice is read
  float* red = smem;  // [kGatherWarps][kStrip]
#pragma unroll
  for (int c = 0; c < kCols; c += 4)
    *reinterpret_cast<float4*>(red + warp * kStrip + lane * kCols + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  __syncthreads();
  const bool split = gridDim.y > 1;
  const float* srow = scale != nullptr ? scale + e * n : nullptr;
  for (int cc = threadIdx.x; cc < kStrip; cc += kGatherThreads) {
    const int oc = blockIdx.x * kStrip + cc;
    if (oc >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kGatherWarps; ++wi) v += red[wi * kStrip + cc];
    if (split)
      partial[((size_t)blockIdx.y * slots + s) * n + oc] = v;
    else
      out[(size_t)s * n + oc] = __float2bfloat16_rn(scaled(v, srow, oc));
  }
  if (!split || !last_of_strip(tickets + (size_t)s * gridDim.x + blockIdx.x, gridDim.y, &last))
    return;
  // the strip's last block: its slices in slice order, the scale, one rounding
  for (int cc = threadIdx.x; cc < kStrip; cc += kGatherThreads) {
    const int oc = blockIdx.x * kStrip + cc;
    if (oc >= n) continue;
    float v = 0.f;
    for (int p = 0; p < (int)gridDim.y; ++p)
      v += __ldcg(partial + ((size_t)p * slots + s) * n + oc);
    out[(size_t)s * n + oc] = __float2bfloat16_rn(scaled(v, srow, oc));
  }
}

template <typename W>
int launch_gather_stream(const void* x, const void* w, const float* scale, const int* ids,
                         int slots, int k, int n, int k_slice, float* partial,
                         unsigned* tickets, void* out, cudaStream_t stream) {
  constexpr int kStrip = 32 * (16 / (int)sizeof(W));
  const int slices = (k + k_slice - 1) / k_slice;
  if (k_slice < 1 || k_slice > kGatherXsFloats || n % (16 / (int)sizeof(W)) ||
      (slices > 1 && (partial == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)max(k_slice, kGatherWarps * kStrip) * sizeof(float);
  const dim3 grid((n + kStrip - 1) / kStrip, slices, slots);
  rk_moe_gather_stream_kernel<W><<<grid, kGatherThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w), scale, ids, slots, k, n,
      k_slice, partial, tickets, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gather, f32 x: grid (column blocks, k slices, slots) and a reduce launch
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kColsPerBlock = kThreads * kColsPerThread;  // 512
constexpr int kMaxSlice = 256;

// Four adjacent weights w[0..3] (16-byte-aligned rows, 4-aligned column)
// in one vector load, as floats (f32 x: every weight type is exact in f32)
__device__ __forceinline__ void load_w4(const int8_t* p, float (&f)[4]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load_w4(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

template <typename W>
__global__ void __launch_bounds__(kThreads) rk_moe_gather_partial_kernel(
    const float* __restrict__ x, const W* __restrict__ w, const int* __restrict__ ids,
    int slots, int k, int n, int k_slice, float* __restrict__ partial) {
  __shared__ float xs[kMaxSlice];
  const int s = blockIdx.z;
  const int k0 = blockIdx.y * k_slice;
  for (int j = threadIdx.x; j < k_slice; j += kThreads) xs[j] = x[(size_t)s * k + k0 + j];
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (col >= n) return;
  const size_t e = (size_t)ids[s];
  const W* wp = w + (e * k + k0) * n + col;
  float acc[kColsPerThread] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int j = 0; j < k_slice; ++j) {
    float wv[kColsPerThread];
    load_w4(wp + (size_t)j * n, wv);
    const float xv = xs[j];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[c] = fmaf(xv, wv[c], acc[c]);
  }
  *reinterpret_cast<float4*>(partial + ((size_t)blockIdx.y * slots + s) * n + col) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__global__ void rk_moe_gather_reduce_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ ids, int slots,
                                            int n, int splits, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= slots * n) return;
  float v = 0.f;
  for (int p = 0; p < splits; ++p) v += partial[(size_t)p * slots * n + idx];
  if (scale != nullptr) v *= scale[(size_t)ids[idx / n] * n + idx % n];
  out[idx] = v;
}

template <typename W>
int launch_gather_f32(const void* x, const void* w, const float* scale, const int* ids,
                      int slots, int k, int n, int k_slice, float* partial, void* out,
                      cudaStream_t stream) {
  if (k_slice < 1 || k_slice > kMaxSlice || k % k_slice || n % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, k / k_slice, slots);
  rk_moe_gather_partial_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const W*>(w), ids, slots, k, n, k_slice,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = slots * n;
  rk_moe_gather_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, scale, ids, slots, n, k / k_slice, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grouped, bf16 rows sorted by expert: grid (column strips, k slices, experts)
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsTiles = 2;    // 8-row tiles of sums a pass keeps in registers
constexpr int kRowsStep = 16;    // k rows a warp's step: one mma.sync deep

// MMA i's A fragment (mma_bf16's layout, rows g and g + 8 = this lane
// group's columns 2i and 2i + 1, k pairs (2c, 2c + 1) and (2c + 8, 2c + 9) =
// this lane's k rows (0, 1) and (2, 3)) from the lane's 16 bytes of each of
// its 4 k rows, cast to bf16
__device__ __forceinline__ void a_frag(const int4 (&r)[4], int i, const int8_t*,
                                       uint32_t (&a)[4]) {
  const uint32_t sel = i % 2 ? 0x7632u : 0x5410u;  // columns 2i, 2i + 1 of both rows
  const uint32_t t01 = __byte_perm(word(r[0], i / 2), word(r[1], i / 2), sel);
  const uint32_t t23 = __byte_perm(word(r[2], i / 2), word(r[3], i / 2), sel);
  a[0] = s8x2_bf16x2(t01);
  a[1] = s8x2_bf16x2(t01 >> 8);
  a[2] = s8x2_bf16x2(t23);
  a[3] = s8x2_bf16x2(t23 >> 8);
}
__device__ __forceinline__ void a_frag(const int4 (&r)[4], int i, const __nv_bfloat16*,
                                       uint32_t (&a)[4]) {
  a[0] = __byte_perm(word(r[0], i), word(r[1], i), 0x5410u);
  a[1] = __byte_perm(word(r[0], i), word(r[1], i), 0x7632u);
  a[2] = __byte_perm(word(r[2], i), word(r[3], i), 0x5410u);
  a[3] = __byte_perm(word(r[2], i), word(r[3], i), 0x7632u);
}
__device__ __forceinline__ void a_frag(const int4 (&r)[4], int i, const float*,
                                       uint32_t (&a)[4]) {
  auto f = [&](int row, int q) { return __uint_as_float(word(r[row], q)); };
  a[0] = pack_bf16x2(f(0, 2 * i), f(1, 2 * i));
  a[1] = pack_bf16x2(f(0, 2 * i + 1), f(1, 2 * i + 1));
  a[2] = pack_bf16x2(f(2, 2 * i), f(3, 2 * i));
  a[3] = pack_bf16x2(f(2, 2 * i + 1), f(3, 2 * i + 1));
}

// four adjacent outputs of one row: the scale, one rounding, one 8-byte store
__device__ __forceinline__ void store_out4(__nv_bfloat16* dst, float4 v, const float* srow,
                                           int col) {
  if (srow != nullptr) {
    v.x *= srow[col]; v.y *= srow[col + 1]; v.z *= srow[col + 2]; v.w *= srow[col + 3];
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

template <typename W>
__global__ void __launch_bounds__(kRowsThreads, 2) rk_moe_grouped_mma_kernel(
    const __nv_bfloat16* __restrict__ xs, const W* __restrict__ w,
    const float* __restrict__ scale, const long long* __restrict__ gsz, int m, int k, int n,
    int steps_per_slice, float* __restrict__ partial, unsigned* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out) {
  constexpr int kCols = 16 / (int)sizeof(W);  // a lane's columns: one 16-byte load a row
  constexpr int kMmas = kCols / 2;            // m16n8k16 products a step and tile
  constexpr int kStrip = 8 * kCols;           // a block's columns (8 lane groups)
  __shared__ __align__(16) float red[kRowsWarps][8][kStrip];
  __shared__ long long warp_rows[kRowsWarps];
  __shared__ int last;
  const int ex = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;

  // the group's first row: the sizes of the experts before it
  long long before = 0;
  for (int i = threadIdx.x; i < ex; i += kRowsThreads) before += gsz[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  if (lane == 0) warp_rows[warp] = before;
  __syncthreads();
  long long start = 0;
#pragma unroll
  for (int i = 0; i < kRowsWarps; ++i) start += warp_rows[i];
  const int len = (int)min(gsz[ex], (long long)m - start);
  if (len <= 0) return;   // an empty group: no rows, no ticket
  const int row0 = (int)start;

  const int steps = k / kRowsStep;
  const int s0 = blockIdx.y * steps_per_slice;
  const int s1 = min(steps, s0 + steps_per_slice);
  const int strip0 = blockIdx.x * kStrip;
  const W* we = w + (size_t)ex * k * n + strip0 + g * kCols;
  const float* srow = scale != nullptr ? scale + (size_t)ex * n : nullptr;
  const bool split = gridDim.y > 1;

  for (int p0 = 0; p0 < len; p0 += 8 * kRowsTiles) {
    const int tiles = min(kRowsTiles, (len - p0 + 7) / 8);
    // this lane's B column: row p0 + 8t + g of each tile (rows past the
    // group load nothing and read as zeros)
    const __nv_bfloat16* xr[kRowsTiles];
    bool live[kRowsTiles];
#pragma unroll
    for (int t = 0; t < kRowsTiles; ++t) {
      const int r = p0 + 8 * t + g;
      live[t] = t < tiles && r < len;
      xr[t] = xs + (size_t)(row0 + (live[t] ? r : 0)) * k + 4 * c;
    }
    float acc[kRowsTiles][kMmas][4];
#pragma unroll
    for (int t = 0; t < kRowsTiles; ++t)
#pragma unroll
      for (int i = 0; i < kMmas; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][i][q] = 0.f;

    int4 wa[4], wb[4];
    uint2 xa[kRowsTiles], xb[kRowsTiles];
    auto load = [&](int4 (&wr)[4], uint2 (&xq)[kRowsTiles], int s) {
      if (s >= s1) return;
      const W* p = we + ((size_t)s * kRowsStep + 4 * c) * n;
#pragma unroll
      for (int r = 0; r < 4; ++r) wr[r] = ld_nc16(p + (size_t)r * n);
#pragma unroll
      for (int t = 0; t < kRowsTiles; ++t)
        xq[t] = live[t] ? *reinterpret_cast<const uint2*>(xr[t] + (size_t)s * kRowsStep)
                        : make_uint2(0u, 0u);
    };
    auto use = [&](const int4 (&wr)[4], const uint2 (&xq)[kRowsTiles], int s) {
      if (s >= s1) return;
#pragma unroll
      for (int i = 0; i < kMmas; ++i) {
        uint32_t a[4];
        a_frag(wr, i, w, a);
#pragma unroll
        for (int t = 0; t < kRowsTiles; ++t)
          if (t < tiles) mma_bf16(acc[t][i], a, xq[t].x, xq[t].y);
      }
    };
    int s = s0 + warp;
    load(wa, xa, s);
    for (; s < s1; s += 2 * kRowsWarps) {
      load(wb, xb, s + kRowsWarps);       // in flight while `wa` is consumed
      use(wa, xa, s);
      load(wa, xa, s + 2 * kRowsWarps);   // in flight while `wb` is consumed
      use(wb, xb, s + kRowsWarps);
    }

    // each tile: the warps' sums in warp order (through shared memory),
    // then the output or this slice's partial
#pragma unroll
    for (int t = 0; t < kRowsTiles; ++t) {
      if (t >= tiles) break;
      __syncthreads();   // red is free
#pragma unroll
      for (int i = 0; i < kMmas; ++i) {
        // d0, d2: row 2c at columns 2i, 2i + 1; d1, d3: row 2c + 1
        *reinterpret_cast<float2*>(&red[warp][2 * c][g * kCols + 2 * i]) =
            make_float2(acc[t][i][0], acc[t][i][2]);
        *reinterpret_cast<float2*>(&red[warp][2 * c + 1][g * kCols + 2 * i]) =
            make_float2(acc[t][i][1], acc[t][i][3]);
      }
      __syncthreads();
      for (int q = threadIdx.x; q < 8 * kStrip / 4; q += kRowsThreads) {
        const int r = q / (kStrip / 4), cc = (q % (kStrip / 4)) * 4;
        const int row = p0 + 8 * t + r;
        if (row >= len) continue;
        float4 v = *reinterpret_cast<const float4*>(&red[0][r][cc]);
#pragma unroll
        for (int wi = 1; wi < kRowsWarps; ++wi)
          add4(v, *reinterpret_cast<const float4*>(&red[wi][r][cc]));
        const size_t o = (size_t)(row0 + row) * n + strip0 + cc;
        if (split)
          *reinterpret_cast<float4*>(partial + (size_t)blockIdx.y * m * n + o) = v;
        else
          store_out4(out + o, v, srow, strip0 + cc);
      }
    }
  }
  if (!split || !last_of_strip(tickets + (size_t)ex * gridDim.x + blockIdx.x, gridDim.y, &last))
    return;
  // the (expert, strip)'s last block: its slices in slice order, the scale,
  // one rounding
  for (int q = threadIdx.x; q < len * (kStrip / 4); q += kRowsThreads) {
    const int r = q / (kStrip / 4), cc = (q % (kStrip / 4)) * 4;
    const size_t o = (size_t)(row0 + r) * n + strip0 + cc;
    float4 v = __ldcg(reinterpret_cast<const float4*>(partial + o));
    for (int p = 1; p < (int)gridDim.y; ++p)
      add4(v, __ldcg(reinterpret_cast<const float4*>(partial + (size_t)p * m * n + o)));
    store_out4(out + o, v, srow, strip0 + cc);
  }
}

template <typename W>
int launch_grouped_rows(const void* xs, const void* w, const float* scale,
                        const long long* gsz, int m, int e, int k, int n, int steps_per_slice,
                        float* partial, unsigned* tickets, void* out, cudaStream_t stream) {
  constexpr int kStrip = 8 * (16 / (int)sizeof(W));
  const int steps = k / kRowsStep;
  if (k % kRowsStep || n % kStrip || steps_per_slice < 1 || e < 1 || e > 65535)
    return (int)cudaErrorInvalidValue;
  const int slices = (steps + steps_per_slice - 1) / steps_per_slice;
  if (slices > 1 && (partial == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kStrip, slices, e);
  rk_moe_grouped_mma_kernel<W><<<grid, kRowsThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const W*>(w), scale, gsz, m, k, n,
      steps_per_slice, partial, tickets, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grouped, f32 rows on the padded layout: one block per (tm-row tile,
// 128-column strip)
// ---------------------------------------------------------------------------

constexpr int kGroupedBN = 128;  // columns per block
constexpr int kGroupedBK = 64;   // k a call's rows come in (the kernel steps 32 deep)

// f32 FMAs, one column of the strip a thread, all BM rows in registers; the
// row values are broadcast from shared memory. Tiles from *used_rows on
// hold padding only and exit at once: their rows are never read back.
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
      load_w4(wbase + (size_t)(k0 + r) * n + c, f);
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
int launch_grouped_f32(const void* xp, const void* w, const float* scale, const int* texp,
                       const int* used, int mp, int k, int n, void* out,
                       cudaStream_t stream) {
  const dim3 grid(n / kGroupedBN, mp / BM);
  rk_moe_grouped_f32_kernel<W, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(xp), static_cast<const W*>(w), scale, texp, used, k, n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch_grouped_f32(int tm, const void* xp, const void* w, const float* scale,
                         const int* texp, const int* used, int mp, int k, int n, void* out,
                         cudaStream_t stream) {
  switch (tm) {
    case 8: return launch_grouped_f32<W, 8>(xp, w, scale, texp, used, mp, k, n, out, stream);
    case 16: return launch_grouped_f32<W, 16>(xp, w, scale, texp, used, mp, k, n, out, stream);
    case 32: return launch_grouped_f32<W, 32>(xp, w, scale, texp, used, mp, k, n, out, stream);
    case 64: return launch_grouped_f32<W, 64>(xp, w, scale, texp, used, mp, k, n, out, stream);
    case 128:
      return launch_grouped_f32<W, 128>(xp, w, scale, texp, used, mp, k, n, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (slots, k) in dtype, w (E, k, n) of wtype (0 = float32, 1 = bfloat16,
// 2 = int8), scale (E, n) f32 or null, ids (slots,) int32, out (slots, n)
// in x's dtype. Slice i covers rows [i * k_slice, min(k, (i + 1) * k_slice)).
// bf16 x: n a multiple of 16 / sizeof(w's type), k_slice <= 12288; with more
// than one slice, partial holds slices * slots * n floats and tickets
// slots * ceil(n / strip) zeroed words (the strip: 512 int8, 256 bf16 or
// 128 f32 columns), left zeroed. f32 x: n % 4 == 0, k % k_slice == 0,
// k_slice <= 256, partial always holds (k / k_slice) * slots * n floats;
// tickets is not read. Returns a cudaError_t.
int rk_moe_gather(const void* x, const void* w, const float* scale, const int* ids,
                  int slots, int k, int n, int k_slice, int dtype, int wtype,
                  float* partial, unsigned* tickets, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (wtype == 2)
      return launch_gather_stream<int8_t>(x, w, scale, ids, slots, k, n, k_slice, partial,
                                          tickets, out, s);
    if (wtype == 1)
      return launch_gather_stream<__nv_bfloat16>(x, w, scale, ids, slots, k, n, k_slice,
                                                 partial, tickets, out, s);
    return launch_gather_stream<float>(x, w, scale, ids, slots, k, n, k_slice, partial,
                                       tickets, out, s);
  }
  if (wtype == 2)
    return launch_gather_f32<int8_t>(x, w, scale, ids, slots, k, n, k_slice, partial, out, s);
  if (wtype == 1)
    return launch_gather_f32<__nv_bfloat16>(x, w, scale, ids, slots, k, n, k_slice, partial,
                                            out, s);
  return launch_gather_f32<float>(x, w, scale, ids, slots, k, n, k_slice, partial, out, s);
}

// xs (m, k) bf16 rows sorted by expert, gsz (E,) int64 rows an expert
// (summing to m) on the device, w (E, k, n) of wtype, scale (E, n) f32 or
// null, out (m, n) bf16 in the same row order. k % 16 == 0; n a multiple of
// the strip (128 int8, 64 bf16 or 32 f32 columns). Slice i covers the
// 16-row steps [i * steps_per_slice, (i + 1) * steps_per_slice); with more
// than one slice, partial holds slices * m * n floats and tickets
// E * (n / strip) zeroed words, left zeroed. Returns a cudaError_t.
int rk_moe_grouped_rows(const void* xs, const void* w, const float* scale,
                        const long long* gsz, int m, int e, int k, int n, int steps_per_slice,
                        int wtype, float* partial, unsigned* tickets, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wtype == 2)
    return launch_grouped_rows<int8_t>(xs, w, scale, gsz, m, e, k, n, steps_per_slice,
                                       partial, tickets, out, s);
  if (wtype == 1)
    return launch_grouped_rows<__nv_bfloat16>(xs, w, scale, gsz, m, e, k, n, steps_per_slice,
                                              partial, tickets, out, s);
  return launch_grouped_rows<float>(xs, w, scale, gsz, m, e, k, n, steps_per_slice, partial,
                                    tickets, out, s);
}

// f32 rows on the padded layout: xp (mp, k), rows padded to tm-row tiles;
// w (E, k, n) of wtype, scale (E, n) f32 or null; texp (mp / tm,) int32
// expert per tile; used (1,) int32, the rows the groups fill (tiles from
// there on are skipped); out (mp, n) f32, rows of skipped tiles left
// unwritten. tm in {8, 16, 32, 64, 128}, k % 64 == 0, n % 128 == 0.
int rk_moe_grouped(const void* xp, const void* w, const float* scale,
                   const int* texp, const int* used, int mp, int k, int n, int tm,
                   int wtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kGroupedBK || n % kGroupedBN || mp % tm) return (int)cudaErrorInvalidValue;
  if (wtype == 2)
    return dispatch_grouped_f32<int8_t>(tm, xp, w, scale, texp, used, mp, k, n, out, s);
  if (wtype == 1)
    return dispatch_grouped_f32<__nv_bfloat16>(tm, xp, w, scale, texp, used, mp, k, n, out, s);
  return dispatch_grouped_f32<float>(tm, xp, w, scale, texp, used, mp, k, n, out, s);
}

}  // extern "C"
