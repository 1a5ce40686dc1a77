// The grouped GEMM's weight gradient for Hopper (sm_90a): bf16 rows sorted
// by expert, gsz[e] rows for expert e, and the upstream gradient dy of the
// same rows; dw[e] = xs[rows of e]^T dy[rows of e], an (E, k, n) f32 tensor.
//
// rk_moe_grouped_wgrad replaces no Pallas kernel: the JAX package computes
// dw in XLA (ragmeup_tpu/ops/moe_matmul.py _grouped_kp_bwd, a one-hot
// "me,mk,mn->ekn" einsum with f32 sums, E times the routed products). A
// kernel is needed because no library call gives f32 output over group
// sizes that live on the device (torch._grouped_mm's wgrad writes bf16),
// and the one-hot product multiplies every row by every expert.
//
// What bounds it on this card: a Mixtral projection's dw written once in
// f32 is 8 x 4096 x 14336 x 4 B = 1.88 GB, 0.56 ms at 3.35 TB/s; its
// routed products (2,048 rows) are 240 GFLOP, 0.24 ms at 989 TFLOP/s. So
// bytes, and the store path matters more than the tensor rate.
//
// What the design does about it:
//   - One block a (128 k rows, 128 n columns) tile of one expert's dw, the
//     grid (n tiles fastest, k tiles, experts): the blocks of an expert run
//     together and read its rows of xs and dy from L2. Each output tile is
//     written once, staged in shared memory and stored in 16-byte
//     streaming stores (st.global.cs) of whole 512-byte row pieces.
//   - The reduction walks the expert's rows 32 a stage through a 3-deep
//     cp.async ring (xs's 32 x 128 and dy's 32 x 128 bf16 tiles, rows
//     padded 16 bytes); rows past the group are zero-filled and read
//     nothing. The group's first row and size are read on the device from
//     gsz (no host sync: the call captures in a graph); an expert with no
//     rows writes zeros.
//   - mma.sync m16n8k16 bf16 with f32 sums: xs^T is the A operand and dy
//     the B operand, both through ldmatrix.trans of the row-major tiles;
//     8 warps each hold 64 k rows x 32 columns (64 f32 sums a thread).

#include "common.cuh"

namespace {

constexpr int kWgBK = 128;                 // dw rows (k) a block
constexpr int kWgBN = 128;                 // dw columns (n) a block
constexpr int kWgRS = 32;                  // rows of the reduction a stage
constexpr int kWgStages = 3;
constexpr int kWgThreads = 256;
constexpr int kWgLd = kWgBK * 2 + 16;      // bytes a staged row (kWgBK == kWgBN)
constexpr int kWgTile = kWgRS * kWgLd;     // one operand's stage
constexpr int kWgStageBytes = 2 * kWgTile;
constexpr int kWgOLd = kWgBN + 8;          // floats a staged output row
constexpr int kWgSmem = kWgStages * kWgStageBytes > kWgBK * kWgOLd * 4
                            ? kWgStages * kWgStageBytes : kWgBK * kWgOLd * 4;
static_assert(kWgBK == kWgBN, "xs and dy tiles share a row layout");

__global__ void __launch_bounds__(kWgThreads, 2)
rk_moe_wgrad_kernel(const __nv_bfloat16* __restrict__ xs, const __nv_bfloat16* __restrict__ dy,
                    const int* __restrict__ gsz, int k, int n, float* __restrict__ dw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kWgBN;
  const int k0 = blockIdx.y * kWgBK;
  const int e = blockIdx.z;
  int start = 0;
  for (int i = 0; i < e; ++i) start += __ldg(gsz + i);
  const int count = __ldg(gsz + e);
  const int steps = (count + kWgRS - 1) / kWgRS;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int wm = (warp / 4) * 64;          // this warp's 64 rows of the tile
  const int wn = (warp % 4) * 32;          // and 32 columns

  // this thread's copies: rows cr and cr + 16 of a stage, 16-byte chunk cc
  const int cr = tid / 16;
  const int cc = tid % 16;
  auto load = [&](int step) {
    unsigned char* st = smem + (step % kWgStages) * kWgStageBytes;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = cr + 16 * q;
      const int row = step * kWgRS + r;
      const bool live = row < count;
      const size_t grow = (size_t)start + (live ? row : 0);
      cp_async16(st + r * kWgLd + cc * 16, xs + grow * k + k0 + cc * 8, live);
      cp_async16(st + kWgTile + r * kWgLd + cc * 16, dy + grow * n + n0 + cc * 8, live);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kWgStages - 2>();
    // every warp's copies of this stage have landed, and every warp is done
    // with the stage refilled next
    __syncthreads();
    if (step + kWgStages - 1 < steps) load(step + kWgStages - 1);
    cp_async_commit();
    const unsigned char* xt = smem + (step % kWgStages) * kWgStageBytes;
    const unsigned char* dt = xt + kWgTile;
#pragma unroll
    for (int kk = 0; kk < kWgRS; kk += 16) {
      // A (16 dw rows x 16 reduction rows) = xs^T: matrices (rows kk.., dw
      // rows +0 / +8), (rows kk + 8.., +0 / +8), transposed
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(a[i], xt + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * kWgLd +
                                    (wm + i * 16 + ((lane >> 3) & 1) * 8) * 2);
      // B (16 reduction rows x 8 columns) = dy: b0 rows kk.., b1 rows kk + 8..
      uint32_t b[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, dt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWgLd +
                                 (wn + jj * 16 + (lane >> 4) * 8) * 2);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: acc[i][j] is rows wm + 16i + g (+ 8: q 2, 3), columns wn + 8j
  // + 2c, + 1 of the tile; staged, then stored a 16-byte piece a thread
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(os + (wm + 16 * i + g + 8 * h) * kWgOLd + wn + 8 * j +
                                   2 * c) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  constexpr int kRowChunks = kWgBN / 4;
  float* base = dw + ((size_t)e * k + k0) * n + n0;
#pragma unroll
  for (int q = 0; q < kWgBK * kRowChunks / kWgThreads; ++q) {
    const int i = tid + q * kWgThreads;
    const int r = i / kRowChunks;
    const int ch = i % kRowChunks;
    __stcs(reinterpret_cast<float4*>(base + (size_t)r * n + ch * 4),
           *reinterpret_cast<const float4*>(os + r * kWgOLd + ch * 4));
  }
}

}  // namespace

extern "C" {

// xs (m, k) and dy (m, n) bf16, rows sorted by expert; gsz (E,) int32, the
// groups' sizes on the device (summing to at most m; later rows are in no
// group). dw (E, k, n) f32: every element written. k % 128 == 0, n % 128
// == 0. grid: (n / 128, k / 128, E) blocks, one output tile each (the
// wrapper's wgrad_grid). Returns a cudaError_t.
int rk_moe_grouped_wgrad(const void* xs, const void* dy, const int* gsz, int e, int k, int n,
                         int grid_x, int grid_y, int grid_z, void* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kWgBK || n % kWgBN || grid_x * kWgBN != n || grid_y * kWgBK != k || grid_z != e ||
      e < 1 || grid_y > 65535 || e > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rk_moe_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  rk_moe_wgrad_kernel<<<dim3(grid_x, grid_y, grid_z), kWgThreads, kWgSmem, s>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(dy), gsz, k, n,
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // extern "C"
