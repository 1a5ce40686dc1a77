// Causal flash-attention forward with grouped-query heads for Hopper (sm_90a).
//
// Replaces the Pallas kernels ragmeup_tpu/ops/attention.py::_flash_gqa_kernel
// and ::_flash_kernel (the g = 1 case of the same function).
//
//   q (B, g, s, 128)  - the g query heads that share one kv head
//   k, v (B, kv_len, 128)
//   out (B, g, s, 128): softmax(q k^T * sm_scale, causal) v per head
//
// Query row at position p attends keys 0..p; keys past s (the unused tail of
// a KV cache, kv_len >= s) are never read. Prefill is bound by the two
// products (4 flops per (query, key) pair and head dim), not by memory: the
// score tile never leaves the SM.
//
// bf16 (rk_flash_gqa_mma_kernel): the products run on the tensor cores.
// - One block takes 64 query rows of one kv head: all g heads at 64/g
//   positions, so each K/V tile is read once for the g heads that share it.
//   Four warps own 16 rows each.
// - Each warp keeps its 16 x 128 slice of q in registers (mma A fragments)
//   for the whole key walk.
// - K and V stay bf16 in shared memory, 64 keys a tile, filled by a two-stage
//   ring of 16-byte cp.async copies: tile t + 1 is in flight while tile t
//   multiplies. Rows are padded to 272 bytes, so ldmatrix reads them without
//   bank conflicts (V through ldmatrix.trans as the B operand of P V).
// - S = q k^T accumulates in registers (mma.sync m16n8k16, f32); the online
//   softmax runs on those registers (row max and sum over the four lanes
//   that share a row, by shuffles), with sm_scale * log2(e) folded into
//   exp2f. The running sum l adds the f32 p; P is rounded to bf16 and
//   repacked, register to register, as the A operand of P V (the JAX
//   kernel's p.astype(v.dtype)), so P never touches shared memory.
// - Only tiles that reach past the block's first position are masked; tiles
//   past its last position are not visited. Blocks are issued with the most
//   key tiles first, so the short causal tail fills the last wave.
// - The output is divided by l at the end (l == 0 -> 1, as the TPU kernel).
// f32 inputs (rk_flash_gqa_f32_kernel) keep scalar f32 FMAs on f32 copies of
// the tiles in shared memory, since a tensor-core product would round them.

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kRows = 64;         // query rows per block (g heads x 64/g positions)
constexpr int kKeys = 64;         // keys per tile

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;                 // 4 warps x 16 rows
constexpr int kLd = kHd + 8;                     // bf16 per shared row (272 bytes)
constexpr int kTile = kKeys * kLd;               // one k or v tile
constexpr size_t kMmaSmemBytes =                 // q + 2 x (k, v)
    (kRows * kLd + 4 * kTile) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kMmaThreads, 2) rk_flash_gqa_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int g, int s, int kv_len, float scale_log2,
    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kLd;    // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;      // [2][kKeys][kLd]

  const int bq = kRows / g;                        // positions per block
  const int bkv = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // most key tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;       // ldmatrix: matrix, row

  // row r of the block: head r / bq at position q0 + r % bq
  for (int i = tid; i < kRows * 16; i += kMmaThreads) {
    const int r = i / 16, seg = i % 16;
    const int pos = q0 + r % bq;
    const bool ok = pos < s;
    cp_async16(qs + r * kLd + seg * 8,
               q + (((size_t)bkv * g + r / bq) * s + (ok ? pos : 0)) * kHd + seg * 8, ok);
  }
  cp_async_commit();

  const int last_key = min(min(q0 + bq, s), kv_len);  // exclusive
  const int tiles = (last_key + kKeys - 1) / kKeys;
  const __nv_bfloat16* kb = k + (size_t)bkv * kv_len * kHd;
  const __nv_bfloat16* vb = v + (size_t)bkv * kv_len * kHd;
  auto load_kv = [&](int t) {
    __nv_bfloat16* kd = ks + (t & 1) * kTile;
    __nv_bfloat16* vd = vs + (t & 1) * kTile;
    for (int i = tid; i < kKeys * 16; i += kMmaThreads) {
      const int c = i / 16, seg = i % 16;
      const int key = t * kKeys + c;
      const bool ok = key < last_key;              // zeros past it: p * v stays 0
      const size_t off = (size_t)(ok ? key : 0) * kHd + seg * 8;
      cp_async16(kd + c * kLd + seg * 8, kb + off, ok);
      cp_async16(vd + c * kLd + seg * 8, vb + off, ok);
    }
    cp_async_commit();
  };
  load_kv(0);

  // this thread's rows of the mma fragments: ra and ra + 8
  const int ra = warp * 16 + gr, rb = ra + 8;
  const int pos_a = q0 + ra % bq, pos_b = q0 + rb % bq;
  uint32_t qf[8][4];
  float o[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        ldmatrix_x4(qf[kk],
                    qs + (warp * 16 + mrow + 8 * (mat % 2)) * kLd + 16 * kk + 8 * (mat / 2));
    }
    const __nv_bfloat16* kt = ks + (t & 1) * kTile;
    const __nv_bfloat16* vt = vs + (t & 1) * kTile;

    // S = q k^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (16 * jp + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
        mma_bf16(sc[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale into the log2 domain; mask only tiles that reach past q0
    const int key0 = t * kKeys;
    const bool diag = key0 + kKeys - 1 > q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (diag && key0 + 8 * j + 2 * qc + (e & 1) > (e < 2 ? pos_a : pos_b)) x = -INFINITY;
        sc[j][e] = x;
      }

    // online softmax on the registers; the four lanes of a quad share rows
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps exp2 finite: every p is 0
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mu_a);
      sc[j][1] = exp2f(sc[j][1] - mu_a);
      sc[j][2] = exp2f(sc[j][2] - mu_b);
      sc[j][3] = exp2f(sc[j][3] - mu_b);
      sum_a += sc[j][0] + sc[j][1];
      sum_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * al_a + sum_a;   // this lane's share of the row; the quad adds at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }

    // o += bf16(P) V: the S fragments of keys 16 kk.. are P's A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (16 * kk + 8 * (mat % 2) + mrow) * kLd + 8 * (2 * dp + mat / 2));
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
  if (pos_a < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + ra / bq) * s + pos_a) * kHd + 2 * qc);
#pragma unroll
    for (int d = 0; d < 16; ++d) dst[4 * d] = pack_bf16x2(o[d][0] * inv_a, o[d][1] * inv_a);
  }
  if (pos_b < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + rb / bq) * s + pos_b) * kHd + 2 * qc);
#pragma unroll
    for (int d = 0; d < 16; ++d) dst[4 * d] = pack_bf16x2(o[d][2] * inv_b, o[d][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on f32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kQkStride = kHd + 1;  // padded rows: conflict-free column reads
constexpr int kSStride = kKeys + 1;

constexpr size_t kF32SmemFloats = (size_t)kRows * kQkStride   // q
                                + (size_t)kKeys * kQkStride   // k
                                + (size_t)kKeys * kHd         // v
                                + (size_t)kRows * kSStride    // scores / probabilities
                                + 3 * kRows;                  // m, l, alpha
constexpr size_t kF32SmemBytes = kF32SmemFloats * sizeof(float);

__global__ void __launch_bounds__(kF32Threads) rk_flash_gqa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int g, int s, int kv_len, float sm_scale, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kRows][kQkStride]
  float* ks = qs + kRows * kQkStride;      // [kKeys][kQkStride]
  float* vs = ks + kKeys * kQkStride;      // [kKeys][kHd]
  float* ps = vs + kKeys * kHd;            // [kRows][kSStride]
  float* m_row = ps + kRows * kSStride;    // [kRows]
  float* l_row = m_row + kRows;
  float* a_row = l_row + kRows;

  const int bq = kRows / g;                // positions per block
  const int q0 = blockIdx.x * bq;          // first position of this block
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // row r of the block: head r / bq at position q0 + r % bq
  for (int i = tid; i < kRows * kHd; i += kF32Threads) {
    const int r = i / kHd, h = i % kHd;
    const int pos = q0 + r % bq;
    const size_t src = (((size_t)bkv * g + r / bq) * s + pos) * kHd + h;
    qs[r * kQkStride + h] = pos < s ? q[src] : 0.f;
  }
  if (tid < kRows) {
    m_row[tid] = -INFINITY;
    l_row[tid] = 0.f;
  }

  // this thread's output tile: rows ty + 16 i, head dims tx + 16 j
  float o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;

  const int last_key = min(min(q0 + bq, s), kv_len);  // exclusive
  const int tiles = (last_key + kKeys - 1) / kKeys;
  const float* kb = k + (size_t)bkv * kv_len * kHd;
  const float* vb = v + (size_t)bkv * kv_len * kHd;

  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // previous tile's reads of ks/vs/ps are done
    for (int i = tid; i < kKeys * kHd; i += kF32Threads) {
      const int c = i / kHd, h = i % kHd;
      const bool ok = key0 + c < kv_len;
      const size_t src = (size_t)(key0 + c) * kHd + h;
      ks[c * kQkStride + h] = ok ? kb[src] : 0.f;
      vs[c * kHd + h] = ok ? vb[src] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < kHd; ++h) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kQkStride + h];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kQkStride + h];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int pos = q0 + r % bq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int key = key0 + c;
        const bool keep = key <= pos && key < kv_len;
        ps[r * kSStride + c] = keep ? sc[i][j] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive lanes own one row, 16 keys each
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* row = ps + r * kSStride + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with no visible key yet keeps exp() finite: every p is 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_use);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_use);
        a_row[r] = alpha;
        l_row[r] = alpha * l_row[r] + sum;
        m_row[r] = m_new;
      }
    }
    __syncthreads();

    // o = alpha * o + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_row[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
    for (int c = 0; c < kKeys; ++c) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = vs[c * kHd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kSStride + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    if (pos >= s) continue;
    const float l = l_row[r];
    const float linv = l == 0.f ? 1.f : 1.f / l;
    const size_t dst = (((size_t)bkv * g + r / bq) * s + pos) * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[dst + tx + 16 * j] = o[i][j] * linv;
  }
}

}  // namespace

extern "C" {

// q (bkv, g, s, 128), k/v (bkv, kv_len, 128), out like q; dtype 0 = float32
// (scalar kernel), 1 = bfloat16 (tensor-core kernel); g a power of two
// <= 64. Returns a cudaError_t.
int rk_flash_gqa(const void* q, const void* k, const void* v, int bkv, int g,
                 int s, int kv_len, float sm_scale, int dtype, void* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bq = kRows / g;
  const int qblocks = (s + bq - 1) / bq;
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(rk_flash_gqa_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMmaSmemBytes);
    if (err != cudaSuccess) return (int)err;
    rk_flash_gqa_mma_kernel<<<dim3(bkv, qblocks), kMmaThreads, kMmaSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), g, s, kv_len,
        sm_scale * 1.4426950408889634f, static_cast<__nv_bfloat16*>(out));
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(rk_flash_gqa_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kF32SmemBytes);
  if (err != cudaSuccess) return (int)err;
  rk_flash_gqa_f32_kernel<<<dim3(qblocks, bkv), kF32Threads, kF32SmemBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), g, s, kv_len, sm_scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
