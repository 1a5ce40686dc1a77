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
// a KV cache, kv_len >= s) are never read. Prefill at 8B shapes is bound by
// the two products (4 * s^2/2 * hd flops per head), not by memory: the score
// tile stays in shared memory and is never written to device memory.
//
// One block takes 64 query rows of one kv head: all g heads at 64/g
// positions, so each K/V tile is loaded once for the g heads that read it.
// The block walks 64-key tiles up to its diagonal with an online softmax in
// f32 (running max m, sum l, rescale alpha), and divides by l at the end
// (l == 0 -> 1, as the TPU kernel). Products are scalar FMAs on f32 copies
// of the tiles in shared memory; wgmma and TMA are later work.

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kRows = 64;         // query rows per block (g heads x 64/g positions)
constexpr int kKeys = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kQkStride = kHd + 1;  // padded rows: conflict-free column reads
constexpr int kSStride = kKeys + 1;

constexpr size_t kSmemFloats = (size_t)kRows * kQkStride   // q
                             + (size_t)kKeys * kQkStride   // k
                             + (size_t)kKeys * kHd         // v
                             + (size_t)kRows * kSStride    // scores / probabilities
                             + 3 * kRows;                  // m, l, alpha
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);


template <typename T>
__global__ void __launch_bounds__(kThreads) rk_flash_gqa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int g, int s, int kv_len, float sm_scale, T* __restrict__ out) {
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
  for (int i = tid; i < kRows * kHd; i += kThreads) {
    const int r = i / kHd, h = i % kHd;
    const int pos = q0 + r % bq;
    const size_t src = (((size_t)bkv * g + r / bq) * s + pos) * kHd + h;
    qs[r * kQkStride + h] = pos < s ? to_f32(q[src]) : 0.f;
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
  const T* kb = k + (size_t)bkv * kv_len * kHd;
  const T* vb = v + (size_t)bkv * kv_len * kHd;

  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // previous tile's reads of ks/vs/ps are done
    for (int i = tid; i < kKeys * kHd; i += kThreads) {
      const int c = i / kHd, h = i % kHd;
      const bool ok = key0 + c < kv_len;
      const size_t src = (size_t)(key0 + c) * kHd + h;
      ks[c * kQkStride + h] = ok ? to_f32(kb[src]) : 0.f;
      vs[c * kHd + h] = ok ? to_f32(vb[src]) : 0.f;
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
    for (int j = 0; j < 8; ++j) out[dst + tx + 16 * j] = from_f32<T>(o[i][j] * linv);
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, int bkv, int g,
                 int s, int kv_len, float sm_scale, void* out,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rk_flash_gqa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / g;
  const dim3 grid((s + bq - 1) / bq, bkv);
  rk_flash_gqa_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), g, s, kv_len, sm_scale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (bkv, g, s, 128), k/v (bkv, kv_len, 128), out like q; dtype 0 = float32,
// 1 = bfloat16; g a power of two <= 64. Returns a cudaError_t.
int rk_flash_gqa(const void* q, const void* k, const void* v, int bkv, int g,
                 int s, int kv_len, float sm_scale, int dtype, void* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, bkv, g, s, kv_len, sm_scale,
                                       out, st);
  return launch_flash<float>(q, k, v, bkv, g, s, kv_len, sm_scale, out, st);
}

}  // extern "C"
