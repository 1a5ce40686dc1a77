// Causal flash-attention forward with grouped-query heads for Hopper (sm_90a).
//
// Replaces the Pallas kernels ragmeup_tpu/ops/attention.py::_flash_gqa_kernel
// and ::_flash_kernel (the g = 1 case of the same function).
//
//   q (B, g, s, HD)   - the g query heads that share one kv head, 1 <= g <= 64
//   k, v (B, kv_len, HD)
//   out (B, g, s, HD): softmax(q k^T * sm_scale, causal) v per head
//
// HD is a template parameter, instantiated at 128 (Llama, Mistral, Qwen) and
// 256 (Gemma). Query row at position p attends keys 0..p; keys past s (the
// unused tail of a KV cache, kv_len >= s) are never read. Prefill is bound by
// the two products (4 flops per (query, key) pair and head dim), not by
// memory: the score tile never leaves the SM.
//
// A block takes 64 query rows of one kv head: all g heads at bq = 64 / g
// positions (rounded down), so each K/V tile is read once for the g heads
// that share it. Row r is head r / bq at position q0 + r % bq; where g does
// not divide 64 (Qwen2.5-7B's g = 7: 9 positions, 63 rows) the rows from
// g * bq on are idle: they load zeros and are never written.
//
// bf16 (rk_flash_gqa_mma_kernel): the products run on the tensor cores.
// - Four warps own 16 rows each.
// - At HD 128 each warp keeps its 16 x 128 slice of q in registers (mma A
//   fragments) for the whole key walk. At HD 256 that slice and the 16 x 256
//   f32 output accumulators would need more than the 255 registers a thread
//   may have, so q stays in shared memory and is read by ldmatrix at each
//   k-step, and the key tile halves to 32 keys (half the score registers).
// - K and V stay bf16 in shared memory (64 keys a tile at HD 128, 32 at HD
//   256), filled by a two-stage ring of 16-byte cp.async copies: tile t + 1
//   is in flight while tile t multiplies. Rows are padded by 16 bytes (272 or
//   528 bytes), so ldmatrix reads them without bank conflicts (V through
//   ldmatrix.trans as the B operand of P V). Two blocks fit an SM at both
//   head dims (85 KB and 99 KB of shared memory).
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

constexpr int kRows = 64;         // query rows per block (g heads x 64/g positions)

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;                 // 4 warps x 16 rows

template <int HD>
struct MmaShape {
  static constexpr int kKeys = HD == 256 ? 32 : 64;   // keys per tile
  static constexpr bool kQRegs = HD == 128;           // q fragments held in registers
  static constexpr int kLd = HD + 8;                  // bf16 per shared row
  static constexpr int kSeg = HD / 8;                 // 16-byte segments a row
  static constexpr int kTile = kKeys * kLd;           // one k or v tile
  static constexpr size_t kSmemBytes =                // q + 2 x (k, v)
      (kRows * kLd + 4 * kTile) * sizeof(__nv_bfloat16);
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) rk_flash_gqa_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int g, int s, int kv_len, float scale_log2,
    __nv_bfloat16* __restrict__ out) {
  using S = MmaShape<HD>;
  constexpr int kKeys = S::kKeys, kLd = S::kLd, kSeg = S::kSeg, kTile = S::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * kLd;    // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;      // [2][kKeys][kLd]

  const int bq = kRows / g;                        // positions per block
  const int used = g * bq;                         // rows that hold a (head, position)
  const int bkv = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // most key tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;       // ldmatrix: matrix, row

  // row r of the block: head r / bq at position q0 + r % bq
  for (int i = tid; i < kRows * kSeg; i += kMmaThreads) {
    const int r = i / kSeg, seg = i % kSeg;
    const int pos = q0 + r % bq;
    const bool ok = r < used && pos < s;
    cp_async16(qs + r * kLd + seg * 8,
               q + (((size_t)bkv * g + (ok ? r / bq : 0)) * s + (ok ? pos : 0)) * HD + seg * 8,
               ok);
  }
  cp_async_commit();

  const int last_key = min(min(q0 + bq, s), kv_len);  // exclusive
  const int tiles = (last_key + kKeys - 1) / kKeys;
  const __nv_bfloat16* kb = k + (size_t)bkv * kv_len * HD;
  const __nv_bfloat16* vb = v + (size_t)bkv * kv_len * HD;
  auto load_kv = [&](int t) {
    __nv_bfloat16* kd = ks + (t & 1) * kTile;
    __nv_bfloat16* vd = vs + (t & 1) * kTile;
    for (int i = tid; i < kKeys * kSeg; i += kMmaThreads) {
      const int c = i / kSeg, seg = i % kSeg;
      const int key = t * kKeys + c;
      const bool ok = key < last_key;              // zeros past it: p * v stays 0
      const size_t off = (size_t)(ok ? key : 0) * HD + seg * 8;
      cp_async16(kd + c * kLd + seg * 8, kb + off, ok);
      cp_async16(vd + c * kLd + seg * 8, vb + off, ok);
    }
    cp_async_commit();
  };
  load_kv(0);

  // this thread's rows of the mma fragments: ra and ra + 8
  const int ra = warp * 16 + gr, rb = ra + 8;
  const int pos_a = q0 + ra % bq, pos_b = q0 + rb % bq;
  const __nv_bfloat16* qrow = qs + (warp * 16 + mrow + 8 * (mat % 2)) * kLd + 8 * (mat / 2);
  uint32_t qf[S::kQRegs ? HD / 16 : 1][4];
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (S::kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qrow + 16 * kk);
      }
    }
    const __nv_bfloat16* kt = ks + (t & 1) * kTile;
    const __nv_bfloat16* vt = vs + (t & 1) * kTile;

    // S = q k^T: 16 rows x kKeys keys a warp, n-tiles of 8 keys
    float sc[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (S::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, qrow + 16 * kk);
      }
#pragma unroll
      for (int jp = 0; jp < kKeys / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (16 * jp + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
        mma_bf16(sc[2 * jp], qa, b[0], b[1]);
        mma_bf16(sc[2 * jp + 1], qa, b[2], b[3]);
      }
    }

    // scale into the log2 domain; mask only tiles that reach past q0
    const int key0 = t * kKeys;
    const bool diag = key0 + kKeys - 1 > q0;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (diag && key0 + 8 * j + 2 * qc + (e & 1) > (e < 2 ? pos_a : pos_b)) x = -INFINITY;
        sc[j][e] = x;
      }

    // online softmax on the registers; the four lanes of a quad share rows
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
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
    for (int j = 0; j < kKeys / 8; ++j) {
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
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }

    // o += bf16(P) V: the S fragments of keys 16 kk.. are P's A fragment
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
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
  if (ra < used && pos_a < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + ra / bq) * s + pos_a) * HD + 2 * qc);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) dst[4 * d] = pack_bf16x2(o[d][0] * inv_a, o[d][1] * inv_a);
  }
  if (rb < used && pos_b < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + rb / bq) * s + pos_b) * HD + 2 * qc);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) dst[4 * d] = pack_bf16x2(o[d][2] * inv_b, o[d][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on f32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kKeys = 64;           // keys per tile
constexpr int kSStride = kKeys + 1;

template <int HD>
constexpr size_t f32_smem_bytes() {
  return ((size_t)kRows * (HD + 1)     // q, padded rows: conflict-free column reads
          + (size_t)kKeys * (HD + 1)   // k
          + (size_t)kKeys * HD         // v
          + (size_t)kRows * kSStride   // scores / probabilities
          + 3 * kRows) * sizeof(float);  // m, l, alpha
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads) rk_flash_gqa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int g, int s, int kv_len, float sm_scale, float* __restrict__ out) {
  constexpr int kQkStride = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kRows][kQkStride]
  float* ks = qs + kRows * kQkStride;      // [kKeys][kQkStride]
  float* vs = ks + kKeys * kQkStride;      // [kKeys][HD]
  float* ps = vs + kKeys * HD;             // [kRows][kSStride]
  float* m_row = ps + kRows * kSStride;    // [kRows]
  float* l_row = m_row + kRows;
  float* a_row = l_row + kRows;

  const int bq = kRows / g;                // positions per block
  const int used = g * bq;                 // rows that hold a (head, position)
  const int q0 = blockIdx.x * bq;          // first position of this block
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // row r of the block: head r / bq at position q0 + r % bq
  for (int i = tid; i < kRows * HD; i += kF32Threads) {
    const int r = i / HD, h = i % HD;
    const int pos = q0 + r % bq;
    const bool ok = r < used && pos < s;
    qs[r * kQkStride + h] = ok ? q[(((size_t)bkv * g + r / bq) * s + pos) * HD + h] : 0.f;
  }
  if (tid < kRows) {
    m_row[tid] = -INFINITY;
    l_row[tid] = 0.f;
  }

  // this thread's output tile: rows ty + 16 i, head dims tx + 16 j
  float o[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) o[i][j] = 0.f;

  const int last_key = min(min(q0 + bq, s), kv_len);  // exclusive
  const int tiles = (last_key + kKeys - 1) / kKeys;
  const float* kb = k + (size_t)bkv * kv_len * HD;
  const float* vb = v + (size_t)bkv * kv_len * HD;

  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // previous tile's reads of ks/vs/ps are done
    for (int i = tid; i < kKeys * HD; i += kF32Threads) {
      const int c = i / HD, h = i % HD;
      const bool ok = key0 + c < kv_len;
      const size_t src = (size_t)(key0 + c) * HD + h;
      ks[c * kQkStride + h] = ok ? kb[src] : 0.f;
      vs[c * HD + h] = ok ? vb[src] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; ++h) {
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
      for (int j = 0; j < HD / 16; ++j) o[i][j] *= alpha;
    }
    for (int c = 0; c < kKeys; ++c) {
      float vv[HD / 16];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kSStride + c];
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    if (r >= used || pos >= s) continue;
    const float l = l_row[r];
    const float linv = l == 0.f ? 1.f : 1.f / l;
    const size_t dst = (((size_t)bkv * g + r / bq) * s + pos) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) out[dst + tx + 16 * j] = o[i][j] * linv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int bkv, int g, int s, int kv_len,
           float sm_scale, int dtype, void* out, cudaStream_t st) {
  const int bq = kRows / g;
  const int qblocks = (s + bq - 1) / bq;
  if (dtype == 1) {
    constexpr size_t bytes = MmaShape<HD>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(rk_flash_gqa_mma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    rk_flash_gqa_mma_kernel<HD><<<dim3(bkv, qblocks), kMmaThreads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), g, s, kv_len,
        sm_scale * 1.4426950408889634f, static_cast<__nv_bfloat16*>(out));
    return (int)cudaGetLastError();
  }
  constexpr size_t bytes = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(rk_flash_gqa_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rk_flash_gqa_f32_kernel<HD><<<dim3(qblocks, bkv), kF32Threads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), g, s, kv_len, sm_scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (bkv, g, s, hd), k/v (bkv, kv_len, hd), out like q; hd 128 or 256;
// 1 <= g <= 64; dtype 0 = float32 (scalar kernel), 1 = bfloat16
// (tensor-core kernel). Returns a cudaError_t.
int rk_flash_gqa(const void* q, const void* k, const void* v, int bkv, int g,
                 int s, int kv_len, int hd, float sm_scale, int dtype, void* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || g > kRows) return (int)cudaErrorInvalidValue;
  if (hd == 128) return launch<128>(q, k, v, bkv, g, s, kv_len, sm_scale, dtype, out, st);
  if (hd == 256) return launch<256>(q, k, v, bkv, g, s, kv_len, sm_scale, dtype, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
