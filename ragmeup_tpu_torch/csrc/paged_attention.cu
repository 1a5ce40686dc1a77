// Paged attention for Hopper (sm_90a): batched decode and chunk-append
// (chunked prefill) against a page pool, with the K/V rows of each sequence
// gathered through its page table.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/paged_attention.py::_paged_kernel
// in both of its modes (q_len = 1 and q_len > 1).
//
//   q, out (b, q_len, nh, 128)             query rows; decode is q_len = 1
//   k_pages, v_pages (nkv, P, ps, 128)     the pool, one token per row
//   page_idx (b, mp) int32                 each sequence's page table
//   lengths (b,) int32                     tokens per sequence, chunk included
//
// Query position i of a sequence attends key positions p < lim, with
// lim = length - q_len + i + 1 (and p >= lim - window when window > 0, and
// p < mp * ps); softcap > 0 maps the scaled scores to softcap*tanh(s/softcap)
// before the mask. A row that sees no key writes 0 (l == 0, as the TPU
// kernel's emit).
//
// What bounds it: decode (q_len = 1) reads every visible K/V row once per kv
// head and does 4 flops per byte pair, so it is bound by device-memory
// bytes; the 128-token chunk at 8B does 4 * 128 * g flops per K/V element
// read and is bound by the products. One block takes one tile of rows
// (16 rows for decode, 64 for a chunk) of one (sequence, kv head): all g
// query heads of the kv head, rows ordered (position, head in group) as in
// the TPU kernel, so each K/V tile is read once for the g heads that use it.
// The block walks 64-key tiles up to its last row's limit, looks up each
// key's (page, slot) in the page table, keeps the tiles in shared memory as
// f32 and runs the online softmax (running max m, sum l, rescale alpha) in
// f32. Products are scalar FMAs as in flash_attention.cu; wgmma, TMA and
// double-buffered page loads are later work.

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kKeys = 64;           // keys per tile
constexpr int kThreads = 256;
constexpr int kQkStride = kHd + 1;  // padded rows: conflict-free column reads
constexpr int kSStride = kKeys + 1;

template <int kRows>
constexpr size_t smem_bytes() {
  return ((size_t)kRows * kQkStride      // q
          + (size_t)kKeys * kQkStride    // k
          + (size_t)kKeys * kHd          // v
          + (size_t)kRows * kSStride     // scores / probabilities
          + 3 * kRows) * sizeof(float)   // m, l, alpha
         + (size_t)(kKeys + kRows) * sizeof(int);  // key rows, row limits
}


template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) rk_paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps,
    int mp, float sm_scale, int window, float softcap, T* __restrict__ out) {
  constexpr int RI = kRows / 16;            // rows per thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kRows][kQkStride]
  float* ks = qs + kRows * kQkStride;       // [kKeys][kQkStride]
  float* vs = ks + kKeys * kQkStride;       // [kKeys][kHd]
  float* pr = vs + kKeys * kHd;             // [kRows][kSStride]
  float* m_row = pr + kRows * kSStride;     // [kRows]
  float* l_row = m_row + kRows;
  float* a_row = l_row + kRows;
  int* key_row = reinterpret_cast<int*>(a_row + kRows);  // [kKeys] pool row or -1
  int* lim_row = key_row + kKeys;                        // [kRows]

  const int g = nh / nkv;
  const int nrows = q_len * g;
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;

  // row r of the block: position (row0 + r) / g, head kvh * g + (row0 + r) % g
  for (int i = tid; i < kRows * kHd; i += kThreads) {
    const int r = i / kHd, h = i % kHd;
    const int R = row0 + r;
    float x = 0.f;
    if (R < nrows) {
      const size_t src = (((size_t)bi * q_len + R / g) * nh + kvh * g + R % g) * kHd + h;
      x = to_f32(q[src]);
    }
    qs[r * kQkStride + h] = x;
  }
  if (tid < kRows) {
    const int R = row0 + tid;
    lim_row[tid] = R < nrows ? length - q_len + R / g + 1 : 0;
    m_row[tid] = -INFINITY;
    l_row[tid] = 0.f;
  }

  float o[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;

  // keys this block can see: limits grow with the row index
  const int last = min(row0 + kRows, nrows) - 1;
  const int hi_key = min(length - q_len + last / g + 1, mp * ps);   // exclusive
  const int lo_key = window > 0 ? max(0, length - q_len + row0 / g + 1 - window) : 0;
  const int t0 = lo_key / kKeys;
  const int t1 = hi_key > 0 ? (hi_key + kKeys - 1) / kKeys : 0;
  const size_t plane = (size_t)kvh * P * ps;  // first pool row of this kv head

  for (int t = t0; t < t1; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // previous tile's reads of ks/vs/pr/key_row are done
    if (tid < kKeys) {
      const int key = key0 + tid;
      key_row[tid] = key < hi_key ? table[key / ps] * ps + key % ps : -1;
    }
    __syncthreads();
    for (int i = tid; i < kKeys * kHd; i += kThreads) {
      const int c = i / kHd, h = i % kHd;
      const int row = key_row[c];
      float kx = 0.f, vx = 0.f;
      if (row >= 0) {
        const size_t src = (plane + row) * kHd + h;
        kx = to_f32(k_pages[src]);
        vx = to_f32(v_pages[src]);
      }
      ks[c * kQkStride + h] = kx;
      vs[c * kHd + h] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < kHd; ++h) {
      float qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * kQkStride + h];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kQkStride + h];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int lim = lim_row[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int key = key0 + c;
        float s = sc[i][j] * sm_scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool keep = key < hi_key && key < lim;
        if (window > 0) keep = keep && key >= lim - window;
        pr[r * kSStride + c] = keep ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive lanes own one row, 16 keys each (the
    // 16-row tile uses warps 0-1 only; the branch is warp-uniform)
    if (tid < 4 * kRows) {
      const int r = tid / 4;
      const int part = tid % 4;
      float* row = pr + r * kSStride + part * 16;
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
    for (int i = 0; i < RI; ++i) {
      const float alpha = a_row[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
    for (int c = 0; c < kKeys; ++c) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = vs[c * kHd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = pr[(ty + 16 * i) * kSStride + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int R = row0 + r;
    if (R >= nrows) continue;
    const float l = l_row[r];
    const float linv = l == 0.f ? 1.f : 1.f / l;   // no visible key: o == 0
    const size_t dst = (((size_t)bi * q_len + R / g) * nh + kvh * g + R % g) * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[dst + tx + 16 * j] = from_f32<T>(o[i][j] * linv);
  }
}

template <typename T, int kRows>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const int* page_idx, const int* lengths, int b, int q_len,
                 int nh, int nkv, int P, int ps, int mp, float sm_scale,
                 int window, float softcap, void* out, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kRows>();
  cudaError_t err = cudaFuncSetAttribute(
      rk_paged_kernel<T, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nrows = q_len * (nh / nkv);
  const dim3 grid((nrows + kRows - 1) / kRows, nkv, b);
  rk_paged_kernel<T, kRows><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_idx, lengths, q_len, nh, nkv, P, ps,
      mp, sm_scale, window, softcap, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_idx, const int* lengths, int b, int q_len,
                  int nh, int nkv, int P, int ps, int mp, float sm_scale,
                  int window, float softcap, void* out, cudaStream_t stream) {
  if (q_len * (nh / nkv) <= 16)
    return launch_paged<T, 16>(q, k_pages, v_pages, page_idx, lengths, b, q_len,
                               nh, nkv, P, ps, mp, sm_scale, window, softcap,
                               out, stream);
  return launch_paged<T, 64>(q, k_pages, v_pages, page_idx, lengths, b, q_len,
                             nh, nkv, P, ps, mp, sm_scale, window, softcap, out,
                             stream);
}

}  // namespace

extern "C" {

// q/out (b, q_len, nh, 128); k_pages/v_pages (nkv, P, ps, 128); page_idx
// (b, mp) int32; lengths (b,) int32; dtype 0 = float32, 1 = bfloat16;
// window 0 = off, softcap 0 = off. Returns a cudaError_t.
int rk_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                       const void* page_idx, const void* lengths, int b,
                       int q_len, int nh, int nkv, int P, int ps, int mp,
                       float sm_scale, int window, float softcap, int dtype,
                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(page_idx);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(q, k_pages, v_pages, idx, lens, b,
                                        q_len, nh, nkv, P, ps, mp, sm_scale,
                                        window, softcap, out, st);
  return dispatch_rows<float>(q, k_pages, v_pages, idx, lens, b, q_len, nh, nkv,
                              P, ps, mp, sm_scale, window, softcap, out, st);
}

}  // extern "C"
