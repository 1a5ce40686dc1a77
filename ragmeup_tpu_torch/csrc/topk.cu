// Fused dense scoring + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernels ragmeup_tpu/ops/topk.py::_topk_kernel and
// ::_topk_int8_kernel. Those walk the corpus in order on one TPU core and
// carry a running (b, k) top-k in VMEM from one grid step to the next. CUDA
// blocks run in no
// order, so the same function is computed in two passes here:
//
//   pass 1 (rk_topk_score_kernel): each block scores one 1024-column chunk
//     of corpus_t (d, N) for up to 8 query rows. One thread owns 4 columns;
//     neighbouring threads read neighbouring columns of the same d row, so
//     every corpus read is coalesced. The query rows sit in shared memory and
//     the dot accumulates in f32. The chunk's scores live only in registers
//     and shared memory: a bitonic sort ranks them by (-score, index) and the
//     block writes its k best as candidates.
//   pass 2 (rk_topk_merge_kernel): merges up to 1024 candidates of one query
//     row per block the same way, repeated until one block per row remains.
//
// The (b x N) score matrix never reaches device memory. The kernel is bound
// by reading the corpus once (2 bytes per element in bf16); the sort costs
// shared-memory passes that hide behind the next block's loads.
//
// The int8 variant (rk_topk_int8_score_kernel) reads an int8 corpus and
// int8 queries quantized per row by the wrapper. One thread owns 4 ADJACENT
// columns there, so each corpus row comes in as one 4-byte word (a warp
// reads 128 contiguous bytes: one byte per element, half the bf16 stream).
// The dot is an exact int32 sum; the epilogue keeps the TPU kernel's order
// and rounding, (float)acc * q_scale * c_scale + mask, one f32 rounding per
// step (no FMA contraction), so its scores equal the plain version's. The
// merge pass is shared.
//
// Semantics kept from the TPU kernel: ties break to the lowest index; dead
// and padding columns carry the additive mask value -1e30, and a slot that
// no live column fills comes out as (-1e30, -1).

#include "common.cuh"

namespace {

constexpr int kChunk = 1024;   // columns (pass 1) or candidates (pass 2) per block
constexpr int kThreads = 256;
constexpr int kColsPerThread = kChunk / kThreads;
constexpr int kRowsPerBlock = 8;
constexpr float kNegInf = -1e30f;  // ragmeup_tpu.ops.topk.NEG_INF
constexpr int kIntMax = 0x7fffffff;


// (sa, ia) ranks before (sb, ib): higher score first, then lower index.
__device__ __forceinline__ bool ranks_before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of kChunk (score, index) pairs in shared memory into rank
// order. Called by the whole block; synchronises before and after.
__device__ void bitonic_rank_sort(float* s, int* id) {
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < kChunk / 2; t += blockDim.x) {
        const int a = 2 * t - (t & (stride - 1));
        const int b = a + stride;
        const bool forward = (a & size) == 0;
        const float sa = s[a], sb = s[b];
        const int ia = id[a], ib = id[b];
        const bool swap = forward ? ranks_before(sb, ib, sa, ia)
                                  : ranks_before(sa, ia, sb, ib);
        if (swap) {
          s[a] = sb; s[b] = sa;
          id[a] = ib; id[b] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// Writes slot t of a ranked buffer, mapping "never filled by a live column"
// to the TPU kernel's (-1e30, -1).
__device__ __forceinline__ void emit(float s, int i, float* out_s, int* out_i) {
  if (s <= kNegInf) {
    s = kNegInf;
    i = -1;
  }
  *out_s = s;
  *out_i = i;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rk_topk_score_kernel(
    const T* __restrict__ q, const T* __restrict__ corpus_t,
    const float* __restrict__ mask, int b, int d, int n, int k,
    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kRowsPerBlock][d]
  float* ss = qs + kRowsPerBlock * d;        // [kChunk]
  int* si = reinterpret_cast<int*>(ss + kChunk);

  const int chunk = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, b - row0);
  const int col0 = chunk * kChunk;

  for (int i = threadIdx.x; i < kRowsPerBlock * d; i += blockDim.x) {
    const int r = i / d;
    qs[i] = r < rows ? to_f32(q[(size_t)(row0 + r) * d + (i - r * d)]) : 0.f;
  }
  __syncthreads();

  bool ok[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c)
    ok[c] = col0 + c * kThreads + (int)threadIdx.x < n;

  float acc[kRowsPerBlock][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;

  const T* base = corpus_t + col0 + threadIdx.x;
  for (int j = 0; j < d; ++j) {
    float v[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      v[c] = ok[c] ? to_f32(base[(size_t)j * n + c * kThreads]) : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      const float qv = qs[r * d + j];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(qv, v[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    if (r < rows) {  // block-uniform: the barriers below are safe
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int slot = c * kThreads + threadIdx.x;
        const int col = col0 + slot;
        ss[slot] = ok[c] ? acc[r][c] + mask[col] : -INFINITY;
        si[slot] = ok[c] ? col : kIntMax;
      }
      bitonic_rank_sort(ss, si);
      for (int t = threadIdx.x; t < k; t += blockDim.x) {
        const size_t o = ((size_t)(row0 + r) * gridDim.x + chunk) * k + t;
        emit(ss[t], si[t], cand_s + o, cand_i + o);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads) rk_topk_int8_score_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ q_scale,
    const int8_t* __restrict__ corpus_t, const float* __restrict__ c_scale,
    const float* __restrict__ mask, int b, int d, int n, int k,
    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ int smem_i[];
  int* qs = smem_i;                                             // [kRowsPerBlock][d]
  float* ss = reinterpret_cast<float*>(qs + kRowsPerBlock * d);  // [kChunk]
  int* si = reinterpret_cast<int*>(ss + kChunk);

  const int chunk = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, b - row0);
  const int c4 = chunk * kChunk + threadIdx.x * kColsPerThread;  // my 4 columns

  for (int i = threadIdx.x; i < kRowsPerBlock * d; i += blockDim.x) {
    const int r = i / d;
    qs[i] = r < rows ? (int)q[(size_t)(row0 + r) * d + (i - r * d)] : 0;
  }
  __syncthreads();

  const bool ok = c4 < n;  // n % 4 == 0: my 4 columns are all in or all out
  int acc[kRowsPerBlock][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0;

  if (ok) {
    const char4* base = reinterpret_cast<const char4*>(corpus_t + c4);
    const size_t row4 = (size_t)n / kColsPerThread;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      const char4 v = __ldg(base + (size_t)j * row4);
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        const int qv = qs[r * d + j];
        acc[r][0] += qv * (int)v.x;
        acc[r][1] += qv * (int)v.y;
        acc[r][2] += qv * (int)v.z;
        acc[r][3] += qv * (int)v.w;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    if (r < rows) {  // block-uniform: the barriers below are safe
      const float qsc = ok ? q_scale[row0 + r] : 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int slot = threadIdx.x * kColsPerThread + c;
        const int col = c4 + c;
        float s = -INFINITY;
        if (ok) {
          s = __fmul_rn(__fmul_rn(__int2float_rn(acc[r][c]), qsc), c_scale[col]);
          s = __fadd_rn(s, mask[col]);
        }
        ss[slot] = s;
        si[slot] = ok ? col : kIntMax;
      }
      bitonic_rank_sort(ss, si);
      for (int t = threadIdx.x; t < k; t += blockDim.x) {
        const size_t o = ((size_t)(row0 + r) * gridDim.x + chunk) * k + t;
        emit(ss[t], si[t], cand_s + o, cand_i + o);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads) rk_topk_merge_kernel(
    const float* __restrict__ in_s, const int* __restrict__ in_i, int m, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float ss[kChunk];
  __shared__ int si[kChunk];
  const int part = blockIdx.x;
  const int row = blockIdx.y;
  const int base = part * kChunk;
  for (int t = threadIdx.x; t < kChunk; t += blockDim.x) {
    const int j = base + t;
    const bool ok = j < m;
    ss[t] = ok ? in_s[(size_t)row * m + j] : -INFINITY;
    si[t] = ok ? in_i[(size_t)row * m + j] : kIntMax;
  }
  bitonic_rank_sort(ss, si);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const size_t o = ((size_t)row * gridDim.x + part) * k + t;
    emit(ss[t], si[t], out_s + o, out_i + o);
  }
}

// Merges the per-chunk candidates of pass 1 (the first half of ws) down to
// one ranked list per query row, ping-ponging between the two halves of the
// workspace until one part is left.
int merge_candidates(int b, int nchunks, int k, float* ws_s, int* ws_i,
                     float* out_s, int* out_i, cudaStream_t stream) {
  const size_t half = (size_t)b * nchunks * k;
  float* src_s = ws_s;
  int* src_i = ws_i;
  int m = nchunks * k;
  for (;;) {
    const int parts = (m + kChunk - 1) / kChunk;
    float* dst_s = parts == 1 ? out_s : (src_s == ws_s ? ws_s + half : ws_s);
    int* dst_i = parts == 1 ? out_i : (src_i == ws_i ? ws_i + half : ws_i);
    rk_topk_merge_kernel<<<dim3(parts, b), kThreads, 0, stream>>>(
        src_s, src_i, m, k, dst_s, dst_i);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || parts == 1) return (int)err;
    src_s = dst_s;
    src_i = dst_i;
    m = parts * k;
  }
}

template <typename T>
int launch_topk(const void* q, const void* corpus_t, const float* mask, int b,
                int d, int n, int k, float* ws_s, int* ws_i, float* out_s,
                int* out_i, cudaStream_t stream) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  const size_t smem = (size_t)(kRowsPerBlock * d + 2 * kChunk) * sizeof(float);
  const dim3 grid(nchunks, (b + kRowsPerBlock - 1) / kRowsPerBlock);
  rk_topk_score_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(corpus_t), mask, b, d, n,
      k, ws_s, ws_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge_candidates(b, nchunks, k, ws_s, ws_i, out_s, out_i, stream);
}

}  // namespace

extern "C" {

// q (b, d) and corpus_t (d, n) in one dtype (0 = float32, 1 = bfloat16);
// mask (n,) f32 additive; ws_s/ws_i hold 2 * b * ceil(n / 1024) * k
// elements; out (b, k). 1 <= k <= 128, d <= 1024. Returns a cudaError_t.
int rk_topk(const void* q, const void* corpus_t, const float* mask, int b,
            int d, int n, int k, int dtype, float* ws_s, int* ws_i,
            float* out_s, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_topk<__nv_bfloat16>(q, corpus_t, mask, b, d, n, k, ws_s,
                                      ws_i, out_s, out_i, s);
  return launch_topk<float>(q, corpus_t, mask, b, d, n, k, ws_s, ws_i, out_s,
                            out_i, s);
}

// q (b, d) int8 with q_scale (b,) f32; corpus_t (d, n) int8 with c_scale
// (n,) f32; mask (n,) f32 additive; n % 4 == 0; workspace and out as rk_topk.
// 1 <= k <= 128, d <= 1024. Returns a cudaError_t.
int rk_topk_int8(const int8_t* q, const float* q_scale, const int8_t* corpus_t,
                 const float* c_scale, const float* mask, int b, int d, int n,
                 int k, float* ws_s, int* ws_i, float* out_s, int* out_i,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const size_t smem = (size_t)(kRowsPerBlock * d + 2 * kChunk) * sizeof(int);
  const dim3 grid(nchunks, (b + kRowsPerBlock - 1) / kRowsPerBlock);
  rk_topk_int8_score_kernel<<<grid, kThreads, smem, s>>>(
      q, q_scale, corpus_t, c_scale, mask, b, d, n, k, ws_s, ws_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge_candidates(b, nchunks, k, ws_s, ws_i, out_s, out_i, s);
}

const char* rk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
