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
// kernel's emit). Rows of one (sequence, kv head) are ordered (position,
// head in group), as in the TPU kernel, so each K/V tile is read once for
// the g query heads that use it.
//
// Split-KV: the keys [0, mp * ps) are cut into splits of keys_per_split (a
// whole number of 64-key tiles; ops/paged_attention.py::paged_split_plan
// picks it from the shapes and the SM count, never from lengths, which stay
// on the device). With one split a block writes its rows' output; with more,
// each block writes its rows' partial (running max m in the log2 domain, sum
// l, unnormalized o, all f32) to a workspace, a split that sees no key writes
// (m, l) = (-inf, 0), and rk_paged_combine_kernel merges each row's splits in
// split order (no atomics: a greedy stream repeats bit for bit).
//
// bf16 decode (rk_paged_decode_kernel; q_len = 1, g <= 8): bound by bytes
// (4 flops per K/V byte pair). Grid (split, kv head, sequence); one block of
// 4 warps computes the g query heads of one kv head over one split. K/V
// tiles (64 keys x 256 bytes each) come through a two-stage cp.async ring,
// 16 bytes a thread, into 272-byte shared rows; where ps % 64 == 0 (the
// engine's 128-token pages) a tile is one contiguous 16 KB run of the pool
// with one page-table lookup, else each key is looked up. Scores, the online
// softmax (warp shuffles) and P V are f32 on the CUDA cores.
//
// bf16 chunk-append (rk_paged_chunk_kernel; q_len > 1, or g > 8): bound by
// the products. One block takes 64 query rows of one (sequence, kv head),
// four warps of 16 rows; q stays in registers as mma A fragments; K/V come
// through the page table into the same cp.async ring, read by ldmatrix (V by
// ldmatrix.trans); Q K^T runs on mma.sync m16n8k16 bf16 with f32
// accumulation. The TPU kernel keeps p in f32 for P V, so P is split into a
// bf16 high part and a bf16 low part (p - high) and P V is two mmas into the
// same f32 accumulators: p is carried to about 2^-16 relative, not rounded
// to bf16 once. Only tiles that reach a row's limit, the pool's end or a
// window's start are masked; the row tiles with the most keys are issued
// first.
//
// f32 pools (rk_paged_kernel) keep the scalar kernel: a block of 16 or 64
// rows walks 64-key tiles held as f32 in shared memory with scalar FMAs, in
// one split.

#include "common.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kKeys = 64;           // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: K/V tiles through the page table into a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kLd = kHd + 8;               // bf16 per shared row (272 bytes)
constexpr int kTile = kKeys * kLd;         // one k or v tile
constexpr int kThreads = 128;              // 4 warps

// Issue the copies of the 64-key K and V tile at key0 into kd / vd. Keys
// outside [a, e) are zero-filled and not read, so p * v stays 0 there.
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* kd, __nv_bfloat16* vd,
                                             const __nv_bfloat16* kplane,
                                             const __nv_bfloat16* vplane,
                                             const int* table, int ps, int key0,
                                             int a, int e, int tid) {
  const bool whole_page = ps % kKeys == 0;
  const int base = whole_page ? table[key0 / ps] * ps + key0 % ps : 0;
  for (int i = tid; i < kKeys * 16; i += kThreads) {
    const int c = i / 16, seg = i % 16;
    const int key = key0 + c;
    const bool ok = key >= a && key < e;
    const int row = !ok ? 0 : whole_page ? base + c : table[key / ps] * ps + key % ps;
    const size_t off = (size_t)row * kHd + seg * 8;
    cp_async16(kd + c * kLd + seg * 8, kplane + off, ok);
    cp_async16(vd + c * kLd + seg * 8, vplane + off, ok);
  }
  cp_async_commit();
}

// two packed bf16 (the lower address in the low half) as floats
__device__ __forceinline__ float2 bf16x2_f32(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// workspace index of (sequence bi, kv head kvh, row r, split s)
__device__ __forceinline__ size_t ws_row(int bi, int kvh, int r, int s, int nkv,
                                         int rows, int splits) {
  return (((size_t)bi * nkv + kvh) * rows + r) * splits + s;
}

// output row of (sequence bi, kv head kvh, row r): position r / g, head r % g
__device__ __forceinline__ size_t out_row(int bi, int kvh, int r, int g, int q_len,
                                          int nh) {
  return ((size_t)bi * q_len + r / g) * nh + kvh * g + r % g;
}

// ---------------------------------------------------------------------------
// bf16 decode: split-KV on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kMaxG = 8;
constexpr size_t kDecSmemBytes = 4 * (size_t)kTile * sizeof(__nv_bfloat16)  // 2 x (k, v)
                                 + (kMaxG * kHd + kMaxG * kKeys + 3 * kMaxG) * sizeof(float);

__global__ void __launch_bounds__(kThreads) rk_paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;                              // [2][kKeys][kLd]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile);            // [kMaxG][kHd]
  float* pr = qs + kMaxG * kHd;                                    // [kMaxG][kKeys]
  float* al = pr + kMaxG * kKeys;                                  // [kMaxG] alpha
  float* ml = al + kMaxG;                                          // [kMaxG][2] m, l

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int g = nh / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;

  // keys of this split the row sees: [a, e)
  const int kcap = mp * ps;
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int k0 = split * keys_per_split;
  const int a = max(k0, lo);
  const int e = min(min(k0 + keys_per_split, kcap), length);
  if (a >= e) {
    if (tid < g) {
      if (splits == 1) {
        for (int d = 0; d < kHd; ++d)
          out[out_row(bi, kvh, tid, g, 1, nh) * kHd + d] = __float2bfloat16_rn(0.f);
      } else {
        const size_t w = ws_row(bi, kvh, tid, split, nkv, g, splits);
        ws_ml[2 * w] = -INFINITY;
        ws_ml[2 * w + 1] = 0.f;
      }
    }
    return;
  }

  const size_t plane = (size_t)kvh * P * ps * kHd;
  const __nv_bfloat16* kplane = k_pages + plane;
  const __nv_bfloat16* vplane = v_pages + plane;
  const int t0 = a / kKeys, t1 = (e + kKeys - 1) / kKeys;
  load_kv_tile(ks, vs, kplane, vplane, table, ps, t0 * kKeys, a, e, tid);
  for (int i = tid; i < kMaxG * kHd; i += kThreads) {
    const int r = i / kHd, d = i % kHd;
    qs[i] = r < g ? to_f32(q[out_row(bi, kvh, r, g, 1, nh) * kHd + d]) : 0.f;
  }

  // scores: key c = tid % 64 for rows h, h + 2, h + 4, h + 6 (h = tid / 64);
  // P V: dims 2 dp, 2 dp + 1 (dp = tid % 64) over keys kh * 32 .. + 31
  const int c = tid % kKeys, h = tid / kKeys;
  const int dp = tid % kKeys, kh = tid / kKeys;
  const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
  float o[kMaxG][2];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) o[r][0] = o[r][1] = 0.f;
  // warp w owns rows w and w + 4 of the softmax: m, l in every lane
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) {
      load_kv_tile(ks + (stage ^ 1) * kTile, vs + (stage ^ 1) * kTile, kplane, vplane,
                   table, ps, (t + 1) * kKeys, a, e, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kTile;
    const __nv_bfloat16* vt = vs + stage * kTile;

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* krow = kt + c * kLd;
#pragma unroll 4
    for (int d8 = 0; d8 < kHd / 8; ++d8) {
      const uint4 kw = *reinterpret_cast<const uint4*>(krow + 8 * d8);
      const float2 k01 = bf16x2_f32(kw.x), k23 = bf16x2_f32(kw.y);
      const float2 k45 = bf16x2_f32(kw.z), k67 = bf16x2_f32(kw.w);
      const float kf[8] = {k01.x, k01.y, k23.x, k23.y, k45.x, k45.y, k67.x, k67.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = h + 2 * i;
        if (r < g) {
          const float4 q0 = *reinterpret_cast<const float4*>(qs + r * kHd + 8 * d8);
          const float4 q1 = *reinterpret_cast<const float4*>(qs + r * kHd + 8 * d8 + 4);
          s[i] = fmaf(q0.x, kf[0], s[i]); s[i] = fmaf(q0.y, kf[1], s[i]);
          s[i] = fmaf(q0.z, kf[2], s[i]); s[i] = fmaf(q0.w, kf[3], s[i]);
          s[i] = fmaf(q1.x, kf[4], s[i]); s[i] = fmaf(q1.y, kf[5], s[i]);
          s[i] = fmaf(q1.z, kf[6], s[i]); s[i] = fmaf(q1.w, kf[7], s[i]);
        }
      }
    }
    const int key = t * kKeys + c;
    const bool keep = key >= a && key < e;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = h + 2 * i;
      if (r < g) {
        const float x = softcap > 0.f ? tanhf(s[i] * cap_scale) * softcap : s[i] * sm_scale;
        pr[r * kKeys + c] = keep ? x * kLog2e : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax in the log2 domain, one warp per row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp + 4 * i;
      if (r < g) {
        float* row = pr + r * kKeys;
        const float v0 = row[lane], v1 = row[lane + 32];
        float mx = fmaxf(v0, v1);
#pragma unroll
        for (int sh = 16; sh > 0; sh /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_r[i], mx);
        // a row with no visible key yet keeps exp2 finite: every p is 0
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float p0 = exp2f(v0 - mu), p1 = exp2f(v1 - mu);
        float sum = p0 + p1;
#pragma unroll
        for (int sh = 16; sh > 0; sh /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        const float alpha = exp2f(m_r[i] - mu);
        l_r[i] = l_r[i] * alpha + sum;
        m_r[i] = m_new;
        row[lane] = p0;
        row[lane + 32] = p1;
        if (lane == 0) al[r] = alpha;
      }
    }
    __syncthreads();

    // o = alpha * o + p v over this thread's 32 keys
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      if (r < g) {
        const float alpha = al[r];
        o[r][0] *= alpha;
        o[r][1] *= alpha;
      }
    }
#pragma unroll 4
    for (int cc = kh * 32; cc < kh * 32 + 32; ++cc) {
      const float2 v = bf16x2_f32(*reinterpret_cast<const uint32_t*>(vt + cc * kLd + 2 * dp));
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < g) {
          const float p = pr[r * kKeys + cc];
          o[r][0] = fmaf(p, v.x, o[r][0]);
          o[r][1] = fmaf(p, v.y, o[r][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the two key halves: half 1 hands its sums to half 0 through qs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp + 4 * i;
    if (r < g && lane == 0) {
      ml[2 * r] = m_r[i];
      ml[2 * r + 1] = l_r[i];
    }
  }
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < kMaxG; ++r)
      if (r < g) *reinterpret_cast<float2*>(qs + r * kHd + 2 * dp) = make_float2(o[r][0], o[r][1]);
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      if (r >= g) continue;
      const float2 other = *reinterpret_cast<const float2*>(qs + r * kHd + 2 * dp);
      const float o0 = o[r][0] + other.x, o1 = o[r][1] + other.y;
      const float l = ml[2 * r + 1];
      if (splits == 1) {
        const float inv = l == 0.f ? 1.f : __frcp_rn(l);   // no visible key: o == 0
        *reinterpret_cast<uint32_t*>(out + out_row(bi, kvh, r, g, 1, nh) * kHd + 2 * dp) =
            pack_bf16x2(o0 * inv, o1 * inv);
      } else {
        const size_t w = ws_row(bi, kvh, r, split, nkv, g, splits);
        *reinterpret_cast<float2*>(ws_o + w * kHd + 2 * dp) = make_float2(o0, o1);
        if (dp == 0) {
          ws_ml[2 * w] = ml[2 * r];
          ws_ml[2 * w + 1] = l;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 chunk-append: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                 // query rows per block, 16 a warp
constexpr size_t kChunkSmemBytes = (kRows * kLd + 4 * kTile) * sizeof(__nv_bfloat16);

// p as a bf16 high part and the bf16 of what it leaves, both packed in pairs
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

__global__ void __launch_bounds__(kThreads, 2) rk_paged_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kLd]
  __nv_bfloat16* ks = qs + kRows * kLd;                            // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;                              // [2][kKeys][kLd]

  const int split = blockIdx.x, splits = gridDim.x;
  const int kvh = blockIdx.y % nkv, bi = blockIdx.y / nkv;
  const int rt = gridDim.z - 1 - blockIdx.z;      // most key tiles first
  const int g = nh / nkv;
  const int nrows = q_len * g;
  const int row0 = rt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;      // ldmatrix: matrix, row
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;
  const int kcap = mp * ps;

  // the block's rows see keys [lo, hi); this split holds [a, e) of them
  const int last = min(row0 + kRows, nrows) - 1;
  const int lim_first = length - q_len + row0 / g + 1;
  const int lim_last = length - q_len + last / g + 1;
  const int lo = window > 0 ? max(0, lim_first - window) : 0;
  const int k0 = split * keys_per_split;
  const int a = max(k0, lo);
  const int e = min(min(k0 + keys_per_split, kcap), lim_last);

  // this thread's rows of the mma fragments: ra and ra + 8
  const int ra = warp * 16 + gr, rb = ra + 8;
  const int Ra = row0 + ra, Rb = row0 + rb;
  // a row past the chunk sees nothing (lim 0) and is never written
  const int lim_a = Ra < nrows ? length - q_len + Ra / g + 1 : 0;
  const int lim_b = Rb < nrows ? length - q_len + Rb / g + 1 : 0;

  float o[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  if (a < e) {
    // row r of the block: position (row0 + r) / g, head kvh * g + (row0 + r) % g
    for (int i = tid; i < kRows * 16; i += kThreads) {
      const int r = i / 16, seg = i % 16;
      const int R = row0 + r;
      const bool ok = R < nrows;
      cp_async16(qs + r * kLd + seg * 8,
                 q + out_row(bi, kvh, ok ? R : 0, g, q_len, nh) * kHd + seg * 8, ok);
    }
    cp_async_commit();
    const size_t plane = (size_t)kvh * P * ps * kHd;
    const __nv_bfloat16* kplane = k_pages + plane;
    const __nv_bfloat16* vplane = v_pages + plane;
    const int t0 = a / kKeys, t1 = (e + kKeys - 1) / kKeys;
    load_kv_tile(ks, vs, kplane, vplane, table, ps, t0 * kKeys, a, e, tid);
    const float scale_log2 = sm_scale * kLog2e;
    const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
    uint32_t qf[8][4];

    for (int t = t0; t < t1; ++t) {
      const int stage = (t - t0) & 1;
      if (t + 1 < t1) {
        load_kv_tile(ks + (stage ^ 1) * kTile, vs + (stage ^ 1) * kTile, kplane, vplane,
                     table, ps, (t + 1) * kKeys, a, e, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (t == t0) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          ldmatrix_x4(qf[kk],
                      qs + (warp * 16 + mrow + 8 * (mat % 2)) * kLd + 16 * kk + 8 * (mat / 2));
      }
      const __nv_bfloat16* kt = ks + stage * kTile;
      const __nv_bfloat16* vt = vs + stage * kTile;

      // S = q k^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bb[4];
          ldmatrix_x4(bb, kt + (16 * jp + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
          mma_bf16(sc[2 * jp], qf[kk], bb[0], bb[1]);
          mma_bf16(sc[2 * jp + 1], qf[kk], bb[2], bb[3]);
        }
      }

      // scale (softcap) into the log2 domain; mask the tiles that reach a
      // limit, the pool's end or a window's start
      const int key0 = t * kKeys;
      const bool diag = key0 + kKeys > min(lim_first, kcap) ||
                        (window > 0 && key0 < lim_last - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int el = 0; el < 4; ++el) {
          float x;
          if (softcap > 0.f) x = tanhf(sc[j][el] * cap_scale) * softcap * kLog2e;
          else x = sc[j][el] * scale_log2;
          if (diag) {
            const int key = key0 + 8 * j + 2 * qc + (el & 1);
            const int lim = el < 2 ? lim_a : lim_b;
            const bool keep = key < min(lim, kcap) && (window <= 0 || key >= lim - window);
            if (!keep) x = -INFINITY;
          }
          sc[j][el] = x;
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

      // o += P V with P = high + low, both bf16: two mmas per V fragment
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < 8; ++dp) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vt + (16 * kk + 8 * (mat % 2) + mrow) * kLd + 8 * (2 * dp + mat / 2));
          mma_bf16(o[2 * dp], ph, bb[0], bb[1]);
          mma_bf16(o[2 * dp + 1], ph, bb[2], bb[3]);
          mma_bf16(o[2 * dp], pl, bb[0], bb[1]);
          mma_bf16(o[2 * dp + 1], pl, bb[2], bb[3]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it refills
    }
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  // rows ra (o[d][0..1]) and rb (o[d][2..3]): output, or this split's partial
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? Rb : Ra;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    if (R >= nrows) continue;
    if (splits == 1) {
      const float inv = l == 0.f ? 1.f : 1.f / l;   // no visible key: o == 0
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + out_row(bi, kvh, R, g, q_len, nh) * kHd + 2 * qc);
#pragma unroll
      for (int d = 0; d < 16; ++d)
        dst[4 * d] = pack_bf16x2(o[d][2 * half] * inv, o[d][2 * half + 1] * inv);
    } else {
      const size_t w = ws_row(bi, kvh, R, split, nkv, nrows, splits);
      float2* dst = reinterpret_cast<float2*>(ws_o + w * kHd + 2 * qc);
#pragma unroll
      for (int d = 0; d < 16; ++d) dst[4 * d] = make_float2(o[d][2 * half], o[d][2 * half + 1]);
      if (qc == 0) {
        ws_ml[2 * w] = m;
        ws_ml[2 * w + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the merge of the splits, in split order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kHd) rk_paged_combine_kernel(
    const float* __restrict__ ws_ml, const float* __restrict__ ws_o, int splits,
    int rows, int g, int q_len, int nh, int nkv, T* __restrict__ out) {
  const int row = blockIdx.x;                 // (sequence, kv head, row)
  const int r = row % rows, kvh = (row / rows) % nkv, bi = row / (rows * nkv);
  const int d = threadIdx.x;
  const size_t w0 = (size_t)row * splits;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_ml[2 * (w0 + s)]);
  float l = 0.f, o = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float m_s = ws_ml[2 * (w0 + s)];
      if (m_s == -INFINITY) continue;          // a split that saw no key
      const float f = exp2f(m_s - mx);
      l += ws_ml[2 * (w0 + s) + 1] * f;
      o += ws_o[(w0 + s) * kHd + d] * f;
    }
  }
  out[out_row(bi, kvh, r, g, q_len, nh) * kHd + d] = from_f32<T>(l == 0.f ? 0.f : o / l);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on f32 tiles in shared memory, one split
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kQkStride = kHd + 1;  // padded rows: conflict-free column reads
constexpr int kSStride = kKeys + 1;

template <int kR>
constexpr size_t f32_smem_bytes() {
  return ((size_t)kR * kQkStride         // q
          + (size_t)kKeys * kQkStride    // k
          + (size_t)kKeys * kHd          // v
          + (size_t)kR * kSStride        // scores / probabilities
          + 3 * kR) * sizeof(float)      // m, l, alpha
         + (size_t)(kKeys + kR) * sizeof(int);  // key rows, row limits
}

template <int kR>
__global__ void __launch_bounds__(kF32Threads) rk_paged_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps,
    int mp, float sm_scale, int window, float softcap, float* __restrict__ out) {
  constexpr int RI = kR / 16;               // rows per thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kR][kQkStride]
  float* ks = qs + kR * kQkStride;          // [kKeys][kQkStride]
  float* vs = ks + kKeys * kQkStride;       // [kKeys][kHd]
  float* pr = vs + kKeys * kHd;             // [kR][kSStride]
  float* m_row = pr + kR * kSStride;        // [kR]
  float* l_row = m_row + kR;
  float* a_row = l_row + kR;
  int* key_row = reinterpret_cast<int*>(a_row + kR);  // [kKeys] pool row or -1
  int* lim_row = key_row + kKeys;                     // [kR]

  const int g = nh / nkv;
  const int nrows = q_len * g;
  const int row0 = blockIdx.x * kR;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;

  // row r of the block: position (row0 + r) / g, head kvh * g + (row0 + r) % g
  for (int i = tid; i < kR * kHd; i += kF32Threads) {
    const int r = i / kHd, h = i % kHd;
    const int R = row0 + r;
    qs[r * kQkStride + h] = R < nrows ? q[out_row(bi, kvh, R, g, q_len, nh) * kHd + h] : 0.f;
  }
  if (tid < kR) {
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
  const int last = min(row0 + kR, nrows) - 1;
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
    for (int i = tid; i < kKeys * kHd; i += kF32Threads) {
      const int c = i / kHd, h = i % kHd;
      const int row = key_row[c];
      float kx = 0.f, vx = 0.f;
      if (row >= 0) {
        const size_t src = (plane + row) * kHd + h;
        kx = k_pages[src];
        vx = v_pages[src];
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
    if (tid < 4 * kR) {
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
    const size_t dst = out_row(bi, kvh, R, g, q_len, nh) * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[dst + tx + 16 * j] = o[i][j] * linv;
  }
}

template <int kR>
int launch_f32(const float* q, const float* k_pages, const float* v_pages,
               const int* page_idx, const int* lengths, int b, int q_len, int nh,
               int nkv, int P, int ps, int mp, float sm_scale, int window,
               float softcap, float* out, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes<kR>();
  cudaError_t err = cudaFuncSetAttribute(
      rk_paged_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nrows = q_len * (nh / nkv);
  const dim3 grid((nrows + kR - 1) / kR, nkv, b);
  rk_paged_kernel<kR><<<grid, kF32Threads, bytes, stream>>>(
      q, k_pages, v_pages, page_idx, lengths, q_len, nh, nkv, P, ps, mp, sm_scale,
      window, softcap, out);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k_pages,
                const __nv_bfloat16* v_pages, const int* page_idx, const int* lengths,
                int b, int q_len, int nh, int nkv, int P, int ps, int mp,
                float sm_scale, int window, float softcap, int keys_per_split,
                float* workspace, __nv_bfloat16* out, cudaStream_t stream) {
  const int g = nh / nkv;
  const int rows = q_len * g;
  const int splits = (mp * ps + keys_per_split - 1) / keys_per_split;
  float* ws_ml = workspace;
  float* ws_o = splits > 1 ? workspace + (size_t)2 * b * nkv * rows * splits : nullptr;
  cudaError_t err;
  if (q_len == 1 && g <= kMaxG) {
    err = cudaFuncSetAttribute(rk_paged_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDecSmemBytes);
    if (err != cudaSuccess) return (int)err;
    rk_paged_decode_kernel<<<dim3(splits, nkv, b), kThreads, kDecSmemBytes, stream>>>(
        q, k_pages, v_pages, page_idx, lengths, nh, nkv, P, ps, mp, keys_per_split,
        sm_scale, window, softcap, ws_ml, ws_o, out);
  } else {
    err = cudaFuncSetAttribute(rk_paged_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kChunkSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int row_tiles = (rows + kRows - 1) / kRows;
    rk_paged_chunk_kernel<<<dim3(splits, nkv * b, row_tiles), kThreads, kChunkSmemBytes,
                            stream>>>(
        q, k_pages, v_pages, page_idx, lengths, q_len, nh, nkv, P, ps, mp,
        keys_per_split, sm_scale, window, softcap, ws_ml, ws_o, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  rk_paged_combine_kernel<__nv_bfloat16><<<b * nkv * rows, kHd, 0, stream>>>(
      ws_ml, ws_o, splits, rows, g, q_len, nh, nkv, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out (b, q_len, nh, 128); k_pages/v_pages (nkv, P, ps, 128); page_idx
// (b, mp) int32; lengths (b,) int32; dtype 0 = float32 (one split), 1 =
// bfloat16; window 0 = off, softcap 0 = off. bf16: keys_per_split a multiple
// of 64, splits = ceil(mp * ps / keys_per_split); with more than one split
// the workspace holds b * nkv * q_len * (nh / nkv) * splits * (2 + 128)
// floats. Returns a cudaError_t.
int rk_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                       const void* page_idx, const void* lengths, int b,
                       int q_len, int nh, int nkv, int P, int ps, int mp,
                       float sm_scale, int window, float softcap, int dtype,
                       int keys_per_split, void* workspace, void* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(page_idx);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 1) {
    if (keys_per_split <= 0 || keys_per_split % kKeys) return (int)cudaErrorInvalidValue;
    return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k_pages),
                       static_cast<const __nv_bfloat16*>(v_pages), idx, lens, b, q_len,
                       nh, nkv, P, ps, mp, sm_scale, window, softcap, keys_per_split,
                       static_cast<float*>(workspace), static_cast<__nv_bfloat16*>(out), st);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pages);
  const float* vf = static_cast<const float*>(v_pages);
  float* of = static_cast<float*>(out);
  if (q_len * (nh / nkv) <= 16)
    return launch_f32<16>(qf, kf, vf, idx, lens, b, q_len, nh, nkv, P, ps, mp, sm_scale,
                          window, softcap, of, st);
  return launch_f32<64>(qf, kf, vf, idx, lens, b, q_len, nh, nkv, P, ps, mp, sm_scale,
                        window, softcap, of, st);
}

}  // extern "C"
