// Paged attention for Hopper (sm_90a): batched decode and chunk-append
// (chunked prefill) against a page pool, with the K/V rows of each sequence
// gathered through its page table.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/paged_attention.py::_paged_kernel
// in both of its modes (q_len = 1 and q_len > 1).
//
//   q, out (b, q_len, nh, HD)              query rows; decode is q_len = 1
//   k_pages, v_pages (nkv, P, ps, HD)      the pool, one token per row
//   page_idx (b, mp) int32                 each sequence's page table
//   lengths (b,) int32                     tokens per sequence, chunk included
//
// The entry takes the head dims 64 (Qwen2.5-0.5B), 96 (Phi-3-mini), 128
// (Llama, Mistral, Qwen) and 256 (Gemma); each mode and head dim has the
// kernel below that suits it. hd 96 is taken as it is: 6 mma k-steps and
// 12 16-byte segments a row. The TPU kernel pads it to 128 columns for its 128-lane
// tiling (and packs hd 64 two tokens a row); no such rule holds here, and
// padding would read and store a third more bytes in a kernel bound by them.
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
// whole number of the kernel's key tiles, 64 keys or 32 for decode at HD
// 256; ops/paged_attention.py::paged_split_plan
// picks it from the shapes and the SM count, never from lengths, which stay
// on the device). With one split a block writes its rows' output; with more,
// each block writes its rows' partial (running max m in the log2 domain, sum
// l, unnormalized o, all f32) to a workspace, a split that sees no key writes
// (m, l) = (-inf, 0), and rk_paged_combine_kernel merges each row's splits in
// split order (no atomics: a greedy stream repeats bit for bit).
//
// bf16 decode at HD 128 (rk_paged_decode_kernel; q_len = 1, g <= 8): bound
// by bytes (4 flops per K/V byte pair). Grid (split, kv head, sequence); one
// block of 4 warps computes the g query heads of one kv head over one
// split. K/V tiles (64 keys x 2 HD bytes each) come through a two-stage
// cp.async ring, 16 bytes a thread, into shared rows padded by 16 bytes;
// where ps % 64 == 0 (the engine's 128-token pages) a tile is one
// contiguous run of the pool with one page-table lookup, else each key is
// looked up. Scores, the online softmax (warp shuffles) and P V are f32 on
// the CUDA cores; in P V a thread owns column pairs tid % 64 over half the
// keys. (The template's HD-64 and HD-96 instantiations are no longer built.)
//
// bf16 decode at HD 64 and 96 (rk_paged_decode_narrow_kernel; Qwen2.5-0.5B's
// 14/2 heads, Phi-3-mini's 32/32): bound by bytes as well. The HD-128
// kernel left threads idle at these head dims: half the block computed no
// score at g 1, three warps of four waited in the softmax, 16 (HD 96) or 32
// (HD 64) of the 64 column pairs had no column in P V, and each 64-key tile
// took four block barriers. Here every warp stays on the byte stream at
// every g from 1 to 8:
//   - 64-key tiles (rows padded 16 bytes: 144 or 208 bytes, conflict-free
//     for ldmatrix) in a three-stage cp.async ring, one barrier a tile, two
//     tiles in flight while one multiplies (54 KB at HD 64, 78 KB at 96).
//   - Warp w takes the 16 keys 16 w of each tile for all HD columns of o,
//     on mma.sync m16n8k16 as the HD-256 kernel below does: S = q K^T with
//     q's g <= 8 rows padded to 16, then o^T += V^T P^T with the S
//     accumulators as P^T's B fragments (P as a bf16 high part and the bf16
//     of the rest); the four warps' key quarters keep their own m, l and o.
//   - At the split's end the quarters merge through shared memory in warp
//     order (m = max, each scaled by exp2(m_w - m)), every thread taking
//     some of the g x HD outputs; the combine kernel then merges the splits
//     in split order. The split unit stays the 64-key tile.
//   - Why this form: a stream-only copy of the HD-128 kernel's loads
//     (tools/attention_times.py --stream) ran Phi-3-mini's b-8 decode in
//     0.028-0.029 ms on an H100 at 700 W, where the HD-128 form took 0.063,
//     so the bytes were not its limit; this form runs it in 0.035. The
//     blocks-an-SM target of the split plan is per head dim
//     (ops/paged_attention.py: 6 at HD 96, 3 at HD 64, from sweeps).
//
// bf16 decode at HD 256 (rk_paged_decode_mma_kernel; Gemma's 16/8 and 16/16
// heads): bound by bytes as well, 1 KB of K and V a key and kv head. The
// HD-64-128 kernel's 132 KB ring at this head dim left one block of 4
// warps an SM, and its scalar products spent several instructions a K/V
// byte. This kernel keeps the bytes in flight instead:
//   - 32-key tiles (16.5 KB each of K and V, rows padded 16 bytes) in a
//     three-stage cp.async ring of 99 KB, one barrier a tile: two blocks of
//     4 warps are resident on an SM, with two tiles of each in flight while
//     one multiplies (ptxas: 167 registers, 2 x 128 x 167 fits).
//   - The split unit is the 32-key tile (ops/paged_attention.py
//     split_unit); the plan aims at 4 blocks an SM, as at the other head
//     dims (a sweep of 2-16 on the H100 found 4 best here too): 8 splits
//     of 256 keys at 8 sequences of 8 kv heads on 132 SMs.
//   - The products run on mma.sync m16n8k16 (bf16, f32 sums). Warp w takes
//     the 16 keys 16 (w % 2) of each tile for columns 128 (w / 2) of o:
//     S = q K^T with q's g <= 8 rows padded to 16 (K by ldmatrix), then
//     o^T += V^T P^T (V by ldmatrix.trans), whose B operand, P's row r at
//     keys 2c, 2c + 1 and + 8, is the S accumulator layout as it lies: no
//     shuffle, no shared memory, and o^T's 8 query columns hold all g rows.
//     P enters as a bf16 high part and the bf16 of the rest (the chunk
//     kernel's split), so p is carried to about 2^-16 as the TPU kernel
//     carries it in f32; the softmax runs on the registers.
//   - The two key halves keep their own running max, sum and o; at the
//     split's end the odd warps hand theirs to the even ones through shared
//     memory, which merge them (fixed order) and write the split's output
//     or partial; the combine kernel then merges the splits in split order.
//
// bf16 chunk-append at HD 64-128 (rk_paged_chunk_kernel; q_len > 1, or g >
// 8): bound by the products. One block takes 64 query rows of one
// (sequence, kv head), four warps of 16 rows; q stays in registers as mma A
// fragments; K/V come through the page table into the same cp.async ring,
// read by ldmatrix (V by ldmatrix.trans); Q K^T runs on mma.sync m16n8k16
// bf16 with f32 accumulation. The TPU kernel keeps p in f32 for P V, so P is
// split into a bf16 high part and a bf16 low part (p - high) and P V is two
// mmas into the same f32 accumulators: p is carried to about 2^-16
// relative, not rounded to bf16 once. Only tiles that reach a row's limit,
// the pool's end or a window's start are masked; the row tiles with the
// most keys are issued first.
//
// bf16 chunk-append at HD 256 (rk_paged_chunk_wgmma_kernel; Gemma-2-9B's
// prefill chunks and speculative verify chunks): bound by the products
// (a 128-token chunk of 16 heads after 2,048 tokens: about 13 GFLOP with
// P's two parts). At this head dim q's mma fragments and the 16 x 256 f32
// accumulators do not fit a warp's registers, so the mma.sync form re-read q
// at every k-step and walked 32-key tiles. This kernel is built on #8's
// wgmma kernel (csrc/flash_attention.cu, rk_flash_gqa_wgmma_kernel):
//   - A block takes 128 rows of one (sequence, kv head), ordered (position,
//     head in group): two consumer warpgroups of 64 rows and a producer
//     warpgroup that gives its registers to them (setmaxnreg: 24 and 2 x 240,
//     64 bytes of spill; 40 and 2 x 232, as #8 takes, spilled 88 and ran
//     the chunk 5 % slower).
//     q (64 KB) and two stages each of K and V tiles (64 keys x 256, 32 KB)
//     sit in 128-byte-swizzled panels of 64 columns: 192 KB, one block an SM.
//   - K/V through the page table: where a 64-key tile is whole pages or a
//     run of one page (ps % 64 == 0, the engine's 128-token pages: one box
//     of 64 rows a panel; 64 % ps == 0 with ps >= 8, such as 16-token pages:
//     64 / ps boxes of ps rows a panel), the producer's one thread looks up
//     each run's page and copies it by TMA from the pool viewed as (nkv,
//     P * ps, 256), the bytes completing the stage's "full" mbarrier; keys
//     past the page table read as zeros. Other page sizes take cp.async
//     copies by the whole producer warpgroup, each key looked up and keys
//     outside the split's [a, e) zero-filled. Either way a pool row past a
//     row's limit (another sequence's finite data) is masked out of S, so
//     its p, and P V's term, is exactly 0.
//   - S = q K^T is 16 wgmma m64n64k16 from shared memory; the online softmax
//     (scale, softcap, mask) runs on the 64 x 64 f32 tile in registers, the
//     softcap as softcap (1 - 2 / (e^(2 s / softcap) + 1)) on two MUFU
//     operations (tanhf took a fifth of Gemma-2's chunk; this form is within
//     a few ulps of 1 of tanh, about 1e-5 of a logit at softcap 50). P's
//     bf16 high and low parts are the register A operands of two wgmma
//     m64n256k16 a 16-key step over V as it lies (MN-major B), into the
//     same 64 x 256 f32 o: 8 wgmmas a tile, p carried to about 2^-16 as in
//     the other paged kernels (the TPU kernel keeps it in f32).
//   - Step t issues S of tile t + 1 and then P V of tile t; the two
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs beside the other's products. Tiles are masked only where they
//     reach a row's limit, the pool's end or a window's start; a warpgroup
//     stops multiplying at its last row's limit. Row blocks with the most
//     keys are issued first; the splits merge in the combine kernel.
//   - The spec waves' verify chunk (q_len 8 at g 2: 16 rows a (sequence, kv
//     head)) fills part of one warpgroup's 64-row slice and leaves the
//     other idle; that shape is bound by its K/V bytes, which the producer
//     streams at the block's pace, and the split plan gives it more splits
//     (one block a (sequence, kv head, split), aiming at an SM each).
//
// f32 pools (rk_paged_kernel) keep the scalar kernel: a block of 16 or 64
// rows walks 64-key tiles held as f32 in shared memory with scalar FMAs, in
// one split (215 KB of shared memory at HD 256).

#include "common.cuh"

namespace {

constexpr int kKeys = 64;           // keys per split unit (and per decode / f32 tile)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: K/V tiles through the page table into a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;              // 4 warps

template <int HD>
struct Rows {
  static constexpr int kLd = HD + 8;       // bf16 per shared row (16 bytes of padding)
  static constexpr int kSeg = HD / 8;      // 16-byte segments a row
};

// Issue the copies of the KT-key K and V tile at key0 into kd / vd. Keys
// outside [a, e) are zero-filled and not read, so p * v stays 0 there.
template <int HD, int KT>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* kd, __nv_bfloat16* vd,
                                             const __nv_bfloat16* kplane,
                                             const __nv_bfloat16* vplane,
                                             const int* table, int ps, int key0,
                                             int a, int e, int tid) {
  constexpr int kLd = Rows<HD>::kLd, kSeg = Rows<HD>::kSeg;
  const bool whole_page = ps % KT == 0;
  const int base = whole_page ? table[key0 / ps] * ps + key0 % ps : 0;
  for (int i = tid; i < KT * kSeg; i += kThreads) {
    const int c = i / kSeg, seg = i % kSeg;
    const int key = key0 + c;
    const bool ok = key >= a && key < e;
    const int row = !ok ? 0 : whole_page ? base + c : table[key / ps] * ps + key % ps;
    const size_t off = (size_t)row * HD + seg * 8;
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

template <int HD>
constexpr size_t dec_smem_bytes() {
  return 4 * (size_t)kKeys * Rows<HD>::kLd * sizeof(__nv_bfloat16)   // 2 x (k, v)
         + (kMaxG * HD + kMaxG * kKeys + 3 * kMaxG) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) rk_paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  constexpr int kLd = Rows<HD>::kLd, kTile = kKeys * kLd;
  constexpr int kPairs = HD / 2;                      // column pairs of a row
  constexpr int kPP = (kPairs + kKeys - 1) / kKeys;   // pairs a thread owns in P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;                              // [2][kKeys][kLd]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile);            // [kMaxG][HD]
  float* pr = qs + kMaxG * HD;                                     // [kMaxG][kKeys]
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
        for (int d = 0; d < HD; ++d)
          out[out_row(bi, kvh, tid, g, 1, nh) * HD + d] = __float2bfloat16_rn(0.f);
      } else {
        const size_t w = ws_row(bi, kvh, tid, split, nkv, g, splits);
        ws_ml[2 * w] = -INFINITY;
        ws_ml[2 * w + 1] = 0.f;
      }
    }
    return;
  }

  const size_t plane = (size_t)kvh * P * ps * HD;
  const __nv_bfloat16* kplane = k_pages + plane;
  const __nv_bfloat16* vplane = v_pages + plane;
  const int t0 = a / kKeys, t1 = (e + kKeys - 1) / kKeys;
  load_kv_tile<HD, kKeys>(ks, vs, kplane, vplane, table, ps, t0 * kKeys, a, e, tid);
  for (int i = tid; i < kMaxG * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[i] = r < g ? to_f32(q[out_row(bi, kvh, r, g, 1, nh) * HD + d]) : 0.f;
  }

  // scores: key c = tid % 64 for rows h, h + 2, h + 4, h + 6 (h = tid / 64);
  // P V: column pairs dp + 64 j (dp = tid % 64) over keys kh * 32 .. + 31
  const int c = tid % kKeys, h = tid / kKeys;
  const int dp = tid % kKeys, kh = tid / kKeys;
  const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
  float o[kMaxG][kPP][2];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r)
#pragma unroll
    for (int j = 0; j < kPP; ++j) o[r][j][0] = o[r][j][1] = 0.f;
  // warp w owns rows w and w + 4 of the softmax: m, l in every lane
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) {
      load_kv_tile<HD, kKeys>(ks + (stage ^ 1) * kTile, vs + (stage ^ 1) * kTile, kplane,
                              vplane, table, ps, (t + 1) * kKeys, a, e, tid);
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
    for (int d8 = 0; d8 < HD / 8; ++d8) {
      const uint4 kw = *reinterpret_cast<const uint4*>(krow + 8 * d8);
      const float2 k01 = bf16x2_f32(kw.x), k23 = bf16x2_f32(kw.y);
      const float2 k45 = bf16x2_f32(kw.z), k67 = bf16x2_f32(kw.w);
      const float kf[8] = {k01.x, k01.y, k23.x, k23.y, k45.x, k45.y, k67.x, k67.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = h + 2 * i;
        if (r < g) {
          const float4 q0 = *reinterpret_cast<const float4*>(qs + r * HD + 8 * d8);
          const float4 q1 = *reinterpret_cast<const float4*>(qs + r * HD + 8 * d8 + 4);
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
#pragma unroll
        for (int j = 0; j < kPP; ++j) {
          o[r][j][0] *= alpha;
          o[r][j][1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPP; ++j) {
      const int pair = dp + kKeys * j;
      if (kPairs % kKeys != 0 && pair >= kPairs) break;
#pragma unroll 4
      for (int cc = kh * 32; cc < kh * 32 + 32; ++cc) {
        const float2 v = bf16x2_f32(*reinterpret_cast<const uint32_t*>(vt + cc * kLd + 2 * pair));
#pragma unroll
        for (int r = 0; r < kMaxG; ++r) {
          if (r < g) {
            const float p = pr[r * kKeys + cc];
            o[r][j][0] = fmaf(p, v.x, o[r][j][0]);
            o[r][j][1] = fmaf(p, v.y, o[r][j][1]);
          }
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
#pragma unroll
      for (int j = 0; j < kPP; ++j) {
        const int pair = dp + kKeys * j;
        if (r < g && pair < kPairs)
          *reinterpret_cast<float2*>(qs + r * HD + 2 * pair) = make_float2(o[r][j][0], o[r][j][1]);
      }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      if (r >= g) continue;
      const float l = ml[2 * r + 1];
      const size_t w = ws_row(bi, kvh, r, split, nkv, g, splits);
#pragma unroll
      for (int j = 0; j < kPP; ++j) {
        const int pair = dp + kKeys * j;
        if (pair >= kPairs) continue;
        const float2 other = *reinterpret_cast<const float2*>(qs + r * HD + 2 * pair);
        const float o0 = o[r][j][0] + other.x, o1 = o[r][j][1] + other.y;
        if (splits == 1) {
          const float inv = l == 0.f ? 1.f : __frcp_rn(l);   // no visible key: o == 0
          *reinterpret_cast<uint32_t*>(out + out_row(bi, kvh, r, g, 1, nh) * HD + 2 * pair) =
              pack_bf16x2(o0 * inv, o1 * inv);
        } else {
          *reinterpret_cast<float2*>(ws_o + w * HD + 2 * pair) = make_float2(o0, o1);
        }
      }
      if (splits > 1 && dp == 0) {
        ws_ml[2 * w] = ml[2 * r];
        ws_ml[2 * w + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 chunk-append: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                 // query rows per block, 16 a warp

template <int HD>
struct ChunkShape {
  static constexpr int kKeys = 64;                    // keys per tile
  static constexpr int kLd = Rows<HD>::kLd;
  static constexpr int kTile = kKeys * kLd;
  static constexpr size_t kSmemBytes = (kRows * kLd + 4 * kTile) * sizeof(__nv_bfloat16);
};

// p as a bf16 high part and the bf16 of what it leaves, both packed in pairs
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) rk_paged_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  using S = ChunkShape<HD>;
  constexpr int KT = S::kKeys, kLd = S::kLd, kTile = S::kTile, kSeg = Rows<HD>::kSeg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kLd]
  __nv_bfloat16* ks = qs + kRows * kLd;                            // [2][KT][kLd]
  __nv_bfloat16* vs = ks + 2 * kTile;                              // [2][KT][kLd]

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

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  if (a < e) {
    // row r of the block: position (row0 + r) / g, head kvh * g + (row0 + r) % g
    for (int i = tid; i < kRows * kSeg; i += kThreads) {
      const int r = i / kSeg, seg = i % kSeg;
      const int R = row0 + r;
      const bool ok = R < nrows;
      cp_async16(qs + r * kLd + seg * 8,
                 q + out_row(bi, kvh, ok ? R : 0, g, q_len, nh) * HD + seg * 8, ok);
    }
    cp_async_commit();
    const size_t plane = (size_t)kvh * P * ps * HD;
    const __nv_bfloat16* kplane = k_pages + plane;
    const __nv_bfloat16* vplane = v_pages + plane;
    const int t0 = a / KT, t1 = (e + KT - 1) / KT;
    load_kv_tile<HD, KT>(ks, vs, kplane, vplane, table, ps, t0 * KT, a, e, tid);
    const float scale_log2 = sm_scale * kLog2e;
    const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
    const __nv_bfloat16* qrow = qs + (warp * 16 + mrow + 8 * (mat % 2)) * kLd + 8 * (mat / 2);
    uint32_t qf[HD / 16][4];                      // q's A fragments, held in registers

    for (int t = t0; t < t1; ++t) {
      const int stage = (t - t0) & 1;
      if (t + 1 < t1) {
        load_kv_tile<HD, KT>(ks + (stage ^ 1) * kTile, vs + (stage ^ 1) * kTile, kplane,
                             vplane, table, ps, (t + 1) * KT, a, e, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (t == t0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qrow + 16 * kk);
      }
      const __nv_bfloat16* kt = ks + stage * kTile;
      const __nv_bfloat16* vt = vs + stage * kTile;

      // S = q k^T: 16 rows x KT keys a warp, n-tiles of 8 keys
      float sc[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
#pragma unroll
        for (int el = 0; el < 4; ++el) qa[el] = qf[kk][el];
#pragma unroll
        for (int jp = 0; jp < KT / 16; ++jp) {
          uint32_t bb[4];
          ldmatrix_x4(bb, kt + (16 * jp + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
          mma_bf16(sc[2 * jp], qa, bb[0], bb[1]);
          mma_bf16(sc[2 * jp + 1], qa, bb[2], bb[3]);
        }
      }

      // scale (softcap) into the log2 domain; mask the tiles that reach a
      // limit, the pool's end or a window's start
      const int key0 = t * KT;
      const bool diag = key0 + KT > min(lim_first, kcap) ||
                        (window > 0 && key0 < lim_last - window);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
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
      for (int j = 0; j < KT / 8; ++j) {
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
      for (int j = 0; j < KT / 8; ++j) {
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

      // o += P V with P = high + low, both bf16: two mmas per V fragment
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
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
          out + out_row(bi, kvh, R, g, q_len, nh) * HD + 2 * qc);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        dst[4 * d] = pack_bf16x2(o[d][2 * half] * inv, o[d][2 * half + 1] * inv);
    } else {
      const size_t w = ws_row(bi, kvh, R, split, nkv, nrows, splits);
      float2* dst = reinterpret_cast<float2*>(ws_o + w * HD + 2 * qc);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) dst[4 * d] = make_float2(o[d][2 * half], o[d][2 * half + 1]);
      if (qc == 0) {
        ws_ml[2 * w] = m;
        ws_ml[2 * w + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 decode at HD 256: mma.sync, two blocks an SM
// ---------------------------------------------------------------------------

constexpr int kDecKeys256 = 32;                        // keys a tile, and the split unit
constexpr int kDecStages256 = 3;
constexpr int kDecLd256 = Rows<256>::kLd;
constexpr int kDecTile256 = kDecKeys256 * kDecLd256;   // bf16 of one K or V tile
constexpr size_t kDecSmem256 = (size_t)kDecStages256 * 2 * kDecTile256 * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads, 2) rk_paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  constexpr int HD = 256, KT = kDecKeys256, kLd = kDecLd256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][k | v][KT][kLd]

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int g = nh / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;       // ldmatrix: matrix, row
  const int kh = warp & 1, dh = warp >> 1;         // key half of a tile, column half of o
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
        for (int d = 0; d < HD; ++d)
          out[out_row(bi, kvh, tid, g, 1, nh) * HD + d] = __float2bfloat16_rn(0.f);
      } else {
        const size_t w = ws_row(bi, kvh, tid, split, nkv, g, splits);
        ws_ml[2 * w] = -INFINITY;
        ws_ml[2 * w + 1] = 0.f;
      }
    }
    return;
  }

  const size_t plane = (size_t)kvh * P * ps * HD;
  const __nv_bfloat16* kplane = k_pages + plane;
  const __nv_bfloat16* vplane = v_pages + plane;
  const int t0 = a / KT, t1 = (e + KT - 1) / KT;
  auto stage = [&](int t) { return ring + ((t - t0) % kDecStages256) * 2 * kDecTile256; };
  auto load = [&](int t) {
    if (t < t1)
      load_kv_tile<HD, KT>(stage(t), stage(t) + kDecTile256, kplane, vplane, table, ps, t * KT,
                           a, e, tid);
    else
      cp_async_commit();                           // an empty group keeps the count
  };
#pragma unroll
  for (int i = 0; i < kDecStages256 - 1; ++i) load(t0 + i);

  // q as the A operand of S = q K^T: rows gr < g in a0 and a2, rows 8-15 zero
  uint32_t qa[HD / 16][2];
  {
    const uint32_t* qrow =
        reinterpret_cast<const uint32_t*>(q + out_row(bi, kvh, gr < g ? gr : 0, g, 1, nh) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = gr < g ? qrow[8 * kk + qc] : 0u;
      qa[kk][1] = gr < g ? qrow[8 * kk + 4 + qc] : 0u;
    }
  }
  const float scale_log2 = sm_scale * kLog2e;
  const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
  // o^T: columns dh * 128 + 16 i + gr (+ 8: o[i][2..3]) x query rows 2 qc, 2 qc + 1
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r = -INFINITY, l_r = 0.f;               // row gr over this warp's key halves

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kDecStages256 - 2>();
    // every thread's copies of tile t have landed, and every warp is done
    // with tile t - 1, whose stage refills next
    __syncthreads();
    load(t + kDecStages256 - 1);
    const __nv_bfloat16* kt = stage(t);
    const __nv_bfloat16* vt = kt + kDecTile256;

    // S = q k^T over this warp's 16 keys: rows gr, keys 8 j + 2 qc (+ 1)
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bb[4];
      ldmatrix_x4(bb, kt + (16 * kh + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
      const uint32_t qf[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16(sc[0], qf, bb[0], bb[1]);
      mma_bf16(sc[1], qf, bb[2], bb[3]);
    }

    // scale (softcap) into the log2 domain; keys outside [a, e) masked
    const int key0 = t * KT + 16 * kh + 2 * qc;
    float x[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int el = 0; el < 2; ++el) {
        const float y = softcap > 0.f ? tanhf(sc[j][el] * cap_scale) * softcap * kLog2e
                                      : sc[j][el] * scale_log2;
        const int key = key0 + 8 * j + el;
        x[j][el] = key >= a && key < e ? y : -INFINITY;
      }

    // online softmax on the registers; the four lanes of a quad share a row
    float mx = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
#pragma unroll
    for (int sh = 1; sh < 4; sh *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    const float m_new = fmaxf(m_r, mx);
    // a row with no visible key yet keeps exp2 finite: every p is 0
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_r - mu);
    m_r = m_new;
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int el = 0; el < 2; ++el) p[j][el] = exp2f(x[j][el] - mu);
    l_r = l_r * alpha + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);  // the quad adds at the end
    // o^T's rows 2 qc and 2 qc + 1 take their alpha from those rows' quads
    const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * qc);
    const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * qc + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al1;
      o[i][2] *= al0;
      o[i][3] *= al1;
    }

    // o^T += V^T P^T: P^T's B fragment is S's accumulator layout (row gr,
    // keys 2 qc.. and 8 + 2 qc..), P as a bf16 high part and a low part
    uint32_t ph0, pl0, ph1, pl1;
    split_bf16x2(p[0][0], p[0][1], ph0, pl0);
    split_bf16x2(p[1][0], p[1][1], ph1, pl1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, vt + (16 * kh + 8 * (mat / 2) + mrow) * kLd + 128 * dh + 16 * i +
                                8 * (mat % 2));
      mma_bf16(o[i], va, ph0, ph1);
      mma_bf16(o[i], va, pl0, pl1);
    }
  }

  // the two key halves: half 1 hands m, l and o to half 0 through the ring
#pragma unroll
  for (int sh = 1; sh < 4; sh *= 2) l_r += __shfl_xor_sync(0xffffffffu, l_r, sh);
  cp_async_wait<0>();
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [dh][8 rows][128 columns]
  float* mml = mo + 2 * 8 * 128;                   // [dh][8 rows][m, l]
  if (kh == 1) {
    if (qc == 0) {
      mml[2 * (dh * 8 + gr)] = m_r;
      mml[2 * (dh * 8 + gr) + 1] = l_r;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int el = 0; el < 4; ++el)
        mo[(dh * 8 + 2 * qc + (el & 1)) * 128 + 16 * i + gr + 8 * (el >> 1)] = o[i][el];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 2 * qc + h;                      // the query row of o[.][h], o[.][h + 2]
    const float m0 = __shfl_sync(0xffffffffu, m_r, 4 * r);
    const float l0 = __shfl_sync(0xffffffffu, l_r, 4 * r);
    const float m1 = mml[2 * (dh * 8 + r)], l1 = mml[2 * (dh * 8 + r) + 1];
    const float m = fmaxf(m0, m1);
    const float mu = m == -INFINITY ? 0.f : m;
    const float f0 = exp2f(m0 - mu), f1 = exp2f(m1 - mu);
    const float l = l0 * f0 + l1 * f1;
    if (r >= g) continue;
    const size_t w = ws_row(bi, kvh, r, split, nkv, g, splits);
    const float inv = l == 0.f ? 1.f : 1.f / l;   // no visible key: o == 0
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * i + gr + 8 * half;
        const float v = o[i][h + 2 * half] * f0 + mo[(dh * 8 + r) * 128 + col] * f1;
        if (splits == 1)
          out[out_row(bi, kvh, r, g, 1, nh) * HD + 128 * dh + col] = __float2bfloat16_rn(v * inv);
        else
          ws_o[w * HD + 128 * dh + col] = v;
      }
    if (splits > 1 && dh == 0 && gr == 0) {
      ws_ml[2 * w] = m;
      ws_ml[2 * w + 1] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 decode at HD 64 and 96: mma.sync, a warp a 16-key quarter of each tile
// ---------------------------------------------------------------------------

constexpr int kNarrowStages = 3;

template <int HD>
constexpr size_t narrow_smem_bytes() {
  return (size_t)kNarrowStages * 2 * kKeys * Rows<HD>::kLd * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 4) rk_paged_decode_narrow_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  constexpr int KT = kKeys, kLd = Rows<HD>::kLd, kTile = KT * kLd;
  constexpr int kCols = HD / 16;                   // 16-column blocks of o^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][k | v][KT][kLd]

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int splits = gridDim.x;
  const int g = nh / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;       // ldmatrix: matrix, row
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
        for (int d = 0; d < HD; ++d)
          out[out_row(bi, kvh, tid, g, 1, nh) * HD + d] = __float2bfloat16_rn(0.f);
      } else {
        const size_t w = ws_row(bi, kvh, tid, split, nkv, g, splits);
        ws_ml[2 * w] = -INFINITY;
        ws_ml[2 * w + 1] = 0.f;
      }
    }
    return;
  }

  const size_t plane = (size_t)kvh * P * ps * HD;
  const __nv_bfloat16* kplane = k_pages + plane;
  const __nv_bfloat16* vplane = v_pages + plane;
  const int t0 = a / KT, t1 = (e + KT - 1) / KT;
  auto stage = [&](int t) { return ring + ((t - t0) % kNarrowStages) * 2 * kTile; };
  auto load = [&](int t) {
    if (t < t1)
      load_kv_tile<HD, KT>(stage(t), stage(t) + kTile, kplane, vplane, table, ps, t * KT, a, e,
                           tid);
    else
      cp_async_commit();                           // an empty group keeps the count
  };
#pragma unroll
  for (int i = 0; i < kNarrowStages - 1; ++i) load(t0 + i);

  // q as the A operand of S = q K^T: rows gr < g in a0 and a2, rows 8-15 zero
  uint32_t qa[HD / 16][2];
  {
    const uint32_t* qrow =
        reinterpret_cast<const uint32_t*>(q + out_row(bi, kvh, gr < g ? gr : 0, g, 1, nh) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = gr < g ? qrow[8 * kk + qc] : 0u;
      qa[kk][1] = gr < g ? qrow[8 * kk + 4 + qc] : 0u;
    }
  }
  const float scale_log2 = sm_scale * kLog2e;
  const float cap_scale = softcap > 0.f ? sm_scale / softcap : 0.f;
  // o^T: columns 16 i + gr (+ 8: o[i][2..3]) x query rows 2 qc, 2 qc + 1
  float o[kCols][4];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r = -INFINITY, l_r = 0.f;               // row gr over this warp's key quarters

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kNarrowStages - 2>();
    // every thread's copies of tile t have landed, and every warp is done
    // with tile t - 1, whose stage refills next
    __syncthreads();
    load(t + kNarrowStages - 1);
    const __nv_bfloat16* kt = stage(t);
    const __nv_bfloat16* vt = kt + kTile;

    // S = q k^T over this warp's 16 keys: rows gr, keys 8 j + 2 qc (+ 1)
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bb[4];
      ldmatrix_x4(bb, kt + (16 * warp + 8 * (mat / 2) + mrow) * kLd + 16 * kk + 8 * (mat % 2));
      const uint32_t qf[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16(sc[0], qf, bb[0], bb[1]);
      mma_bf16(sc[1], qf, bb[2], bb[3]);
    }

    // scale (softcap) into the log2 domain; keys outside [a, e) masked
    const int key0 = t * KT + 16 * warp + 2 * qc;
    float x[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int el = 0; el < 2; ++el) {
        const float y = softcap > 0.f ? tanhf(sc[j][el] * cap_scale) * softcap * kLog2e
                                      : sc[j][el] * scale_log2;
        const int key = key0 + 8 * j + el;
        x[j][el] = key >= a && key < e ? y : -INFINITY;
      }

    // online softmax on the registers; the four lanes of a quad share a row
    float mx = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
#pragma unroll
    for (int sh = 1; sh < 4; sh *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    const float m_new = fmaxf(m_r, mx);
    // a row with no visible key yet keeps exp2 finite: every p is 0
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_r - mu);
    m_r = m_new;
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int el = 0; el < 2; ++el) p[j][el] = exp2f(x[j][el] - mu);
    l_r = l_r * alpha + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);  // the quad adds at the end
    // o^T's rows 2 qc and 2 qc + 1 take their alpha from those rows' quads
    const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * qc);
    const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * qc + 4);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al1;
      o[i][2] *= al0;
      o[i][3] *= al1;
    }

    // o^T += V^T P^T: P^T's B fragment is S's accumulator layout (row gr,
    // keys 2 qc.. and 8 + 2 qc..), P as a bf16 high part and a low part
    uint32_t ph0, pl0, ph1, pl1;
    split_bf16x2(p[0][0], p[0][1], ph0, pl0);
    split_bf16x2(p[1][0], p[1][1], ph1, pl1);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, vt + (16 * warp + 8 * (mat / 2) + mrow) * kLd + 16 * i + 8 * (mat % 2));
      mma_bf16(o[i], va, ph0, ph1);
      mma_bf16(o[i], va, pl0, pl1);
    }
  }

  // the four key quarters: every warp's m, l and o through the ring, merged
  // in warp order
#pragma unroll
  for (int sh = 1; sh < 4; sh *= 2) l_r += __shfl_xor_sync(0xffffffffu, l_r, sh);
  cp_async_wait<0>();
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [warp][8 rows][HD]
  float* mml = mo + 4 * 8 * HD;                    // [warp][8 rows][m, l]
  if (qc == 0) {
    mml[2 * (warp * 8 + gr)] = m_r;
    mml[2 * (warp * 8 + gr) + 1] = l_r;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i)
#pragma unroll
    for (int el = 0; el < 4; ++el)
      mo[(warp * 8 + 2 * qc + (el & 1)) * HD + 16 * i + gr + 8 * (el >> 1)] = o[i][el];
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, mml[2 * (w * 8 + r)]);
    const float mu = m == -INFINITY ? 0.f : m;
    float l = 0.f, v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(mml[2 * (w * 8 + r)] - mu);
      l += mml[2 * (w * 8 + r) + 1] * f;
      v += mo[(w * 8 + r) * HD + d] * f;
    }
    if (splits == 1) {
      const float inv = l == 0.f ? 1.f : 1.f / l;   // no visible key: o == 0
      out[out_row(bi, kvh, r, g, 1, nh) * HD + d] = __float2bfloat16_rn(v * inv);
    } else {
      const size_t w = ws_row(bi, kvh, r, split, nkv, g, splits);
      ws_o[w * HD + d] = v;
      if (d == 0) {
        ws_ml[2 * w] = m;
        ws_ml[2 * w + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 chunk-append at HD 256: wgmma, a producer warpgroup and two consumers
// ---------------------------------------------------------------------------

constexpr int kPcHD = 256;
constexpr int kPcRows = 128;                       // query rows a block, 64 a consumer warpgroup
constexpr int kPcKeys = 64;                        // keys a tile
constexpr int kPcConsumers = 256;                  // two warpgroups of 64 rows
constexpr int kPcConsumerWarps = kPcConsumers / 32;
constexpr int kPcProducers = 128;                  // and the producer warpgroup
constexpr int kPcThreads = kPcConsumers + kPcProducers;
// registers a thread: 168 at launch (65,536 over 384 threads); the producer
// gives its share to the consumers (2 x 240 + 24 = 3 x 168)
constexpr int kPcProducerRegs = 24, kPcConsumerRegs = 240;
constexpr int kPcQBytes = kPcRows * kPcHD * 2;     // q: four 128-row panels
constexpr int kPcTileBytes = kPcKeys * kPcHD * 2;  // one K or V tile: four 64-row panels
constexpr int kPcStages = 2;                       // the K ring's and the V ring's
constexpr int kPcBars = 1 + 4 * kPcStages;         // q; full and empty of K and V
constexpr int kPcSmem = kPcQBytes + 2 * kPcStages * kPcTileBytes + 8 * kPcBars +
                        1024;                      // + 1024-byte alignment
// V as wgmma's transposed B operand: 64-column chunks of hd one panel
// apart, groups of 8 keys one swizzle atom apart
constexpr uint32_t kPcVChunkBytes = kPcKeys * 128, kPcVGroupBytes = 1024;

// The TMA box of a page size: a tile of 64 keys is 64 / box runs of whole
// pages (or one run of a page) at 1024-byte-aligned rows of each panel;
// 0: no box fits, the producer copies keys with cp.async.
__host__ __device__ __forceinline__ int chunk_box_rows(int ps) {
  return ps % kPcKeys == 0 ? kPcKeys : (kPcKeys % ps == 0 && ps % 8 == 0) ? ps : 0;
}

__global__ void __launch_bounds__(kPcThreads, 1) rk_paged_chunk_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps, int mp,
    int keys_per_split, float sm_scale, int window, float softcap,
    float* __restrict__ ws_ml, float* __restrict__ ws_o,
    __nv_bfloat16* __restrict__ out) {
  constexpr int HD = kPcHD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + kPcQBytes;                  // [stage] K tiles
  unsigned char* vs = ks + kPcStages * kPcTileBytes;   // [stage] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kPcStages * kPcTileBytes);
  uint64_t* full_q = bars;                             // the producer's copies landed
  uint64_t* full_k = bars + 1;                         // [stage]
  uint64_t* full_v = full_k + kPcStages;
  uint64_t* empty_k = full_v + kPcStages;              // [stage]: every consumer warp is done
  uint64_t* empty_v = empty_k + kPcStages;

  const int split = blockIdx.x, splits = gridDim.x;
  const int kvh = blockIdx.y % nkv, bi = blockIdx.y / nkv;
  const int rt = gridDim.z - 1 - blockIdx.z;           // most key tiles first
  const int g = nh / nkv;
  const int nrows = q_len * g;
  const int row0 = rt * kPcRows;
  const int tid = threadIdx.x;
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;
  const int kcap = mp * ps;
  const int box = chunk_box_rows(ps);
  // row R (position R / g, head R % g) sees keys below its limit; a row past
  // the chunk sees nothing and is never written
  auto lim_of = [&](int R) { return R < nrows ? length - q_len + R / g + 1 : 0; };

  // the block's rows see keys from lo; this split holds [a, e) of them
  const int last = min(row0 + kPcRows, nrows) - 1;
  const int lo = window > 0 ? max(0, lim_of(row0) - window) : 0;
  const int k0 = split * keys_per_split;
  const int a = max(k0, lo);
  const int e = min(min(k0 + keys_per_split, kcap), lim_of(last));
  const int t_begin = a / kPcKeys;
  const int tiles = a < e ? (e + kPcKeys - 1) / kPcKeys - t_begin : 0;

  if (tiles == 0) {
    // no key of this split: each row's output 0, or its partial (-inf, 0)
    for (int i = tid; i < kPcRows * (HD / 8); i += kPcThreads) {
      const int R = row0 + i / (HD / 8), c = i % (HD / 8);
      if (R >= nrows) continue;
      if (splits == 1) {
        *reinterpret_cast<uint4*>(out + out_row(bi, kvh, R, g, q_len, nh) * HD + 8 * c) =
            make_uint4(0u, 0u, 0u, 0u);
      } else if (c == 0) {
        const size_t w = ws_row(bi, kvh, R, split, nkv, nrows, splits);
        ws_ml[2 * w] = -INFINITY;
        ws_ml[2 * w + 1] = 0.f;
      }
    }
    return;
  }

  if (tid == 0) {
    mbar_init(full_q, kPcProducers);
#pragma unroll
    for (int st = 0; st < kPcStages; ++st) {
      // TMA: one arrival announces the tile's bytes; cp.async: every producer thread's
      mbar_init(full_k + st, box > 0 ? 1 : kPcProducers);
      mbar_init(full_v + st, box > 0 ? 1 : kPcProducers);
      mbar_init(empty_k + st, kPcConsumerWarps);
      mbar_init(empty_v + st, kPcConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kPcConsumers) {
    // the producer warpgroup: q once, then K and V tile by tile into their
    // rings through the page table, a stage refilled once every consumer
    // warp has released it
    setmaxnreg_dec<kPcProducerRegs>();
    const int lane = tid - kPcConsumers;
    for (int i = lane; i < kPcRows * 32; i += kPcProducers) {
      const int r = i / 32, c = i % 32;
      const int R = row0 + r;
      const bool ok = R < nrows;
      cp_async16(qs + panel_off(r, c, kPcRows),
                 q + out_row(bi, kvh, ok ? R : 0, g, q_len, nh) * HD + c * 8, ok);
    }
    cp_async_mbar_arrive(full_q);
    if (box > 0) {
      // TMA over the pool viewed as (nkv, P * ps, 256): a box of `box` keys is
      // one run of pool rows; keys past the table (ps < 64) read as zeros
      if (lane == 0) {
        for (int j = 0; j < tiles; ++j) {
          const int st = j % kPcStages, use = j / kPcStages, key0 = (t_begin + j) * kPcKeys;
          // the pool row of the box at key c of the tile
          auto row_at = [&](int c) {
            const int key = key0 + c;
            return key < kcap ? table[key / ps] * ps + key % ps : P * ps;
          };
          if (use > 0) mbar_wait(empty_k + st, (use - 1) & 1);
          mbar_expect_tx(full_k + st, kPcTileBytes);
          for (int c0 = 0; c0 < kPcKeys; c0 += box) {
            const int row = row_at(c0);
#pragma unroll
            for (int p = 0; p < 4; ++p)
              tma_load_3d(ks + st * kPcTileBytes + p * kPcKeys * 128 + c0 * 128, &tmap_k, 64 * p,
                          row, kvh, full_k + st);
          }
          if (use > 0) mbar_wait(empty_v + st, (use - 1) & 1);
          mbar_expect_tx(full_v + st, kPcTileBytes);
          for (int c0 = 0; c0 < kPcKeys; c0 += box) {
            const int row = row_at(c0);
#pragma unroll
            for (int p = 0; p < 4; ++p)
              tma_load_3d(vs + st * kPcTileBytes + p * kPcKeys * 128 + c0 * 128, &tmap_v, 64 * p,
                          row, kvh, full_v + st);
          }
        }
      }
    } else {
      // cp.async, each key looked up; keys outside [a, e) zero-filled
      const size_t plane = (size_t)kvh * P * ps * HD;
      for (int j = 0; j < tiles; ++j) {
        const int st = j % kPcStages, use = j / kPcStages, key0 = (t_begin + j) * kPcKeys;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          if (use > 0) mbar_wait((kv ? empty_v : empty_k) + st, (use - 1) & 1);
          unsigned char* dst = (kv ? vs : ks) + st * kPcTileBytes;
          const __nv_bfloat16* src = (kv ? v_pages : k_pages) + plane;
          for (int i = lane; i < kPcKeys * 32; i += kPcProducers) {
            const int c = i / 32, seg = i % 32;
            const int key = key0 + c;
            const bool ok = key >= a && key < e;
            const int row = ok ? table[key / ps] * ps + key % ps : 0;
            cp_async16(dst + panel_off(c, seg, kPcKeys), src + (size_t)row * HD + seg * 8, ok);
          }
          cp_async_mbar_arrive((kv ? full_v : full_k) + st);
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  setmaxnreg_inc<kPcConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  // this warpgroup's rows r_lo .. r_hi: the tiles they reach, and the limits
  // that decide which tiles need the mask
  const int r_lo = row0 + 64 * wg, r_hi = min(r_lo + 64, nrows) - 1;
  const int lim_lo = lim_of(r_lo), lim_hi = lim_of(r_hi);
  const int my_tiles =
      r_hi < r_lo ? 0 : max(0, min((min(e, lim_hi) + kPcKeys - 1) / kPcKeys, t_begin + tiles) - t_begin);
  // this thread's rows of the accumulators: ra and ra + 8
  const int ra = r_lo + 16 * warp + gr, rb = ra + 8;
  const int lim_a = lim_of(ra), lim_b = lim_of(rb);
  const uint32_t q_desc = smem_addr(qs) + 64 * wg * 128;  // the warpgroup's 64 rows of each panel
  const float scale_log2 = sm_scale * kLog2e;
  const float cap_log2 = softcap * kLog2e;                                  // softcap in log2 units
  const float cap_exp2 = softcap > 0.f ? 2.f * kLog2e * sm_scale / softcap : 0.f;

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;                    // the next P V's rescale of o
  float sc[32];
  uint32_t ph[4][4], pl[4][4];                     // P's bf16 high and low parts

  // S = q k^T of the block's j-th tile into sc: 64 rows x 64 keys, 16
  // k-steps over the panels
  auto issue_s = [&](int j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
    const uint32_t kt = smem_addr(ks + (j % kPcStages) * kPcTileBytes);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_64x64(sc, sw128_desc(q_desc + (kk >> 2) * (kPcRows * 128) + (kk & 3) * 32),
                     sw128_desc(kt + (kk >> 2) * (kPcKeys * 128) + (kk & 3) * 32));
    wgmma_commit();
  };
  // the online softmax of key tile t on sc (scaled, softcapped, into the log2
  // domain; masked where the tile reaches a row's limit, the pool's end or a
  // window's start): p in sc, l updated, alpha kept
  auto softmax = [&](int t) {
    const int key0 = t * kPcKeys;
    const bool diag = key0 + kPcKeys > min(lim_lo, kcap) ||
                      (window > 0 && key0 < lim_hi - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        // softcap tanh(s / softcap) = softcap (1 - 2 / (e^(2 s / softcap) + 1))
        const float x0 = sc[4 * j + el];
        float x = softcap > 0.f ? cap_log2 - __fdividef(2.f * cap_log2, exp2f(x0 * cap_exp2) + 1.f)
                                : x0 * scale_log2;
        if (diag) {
          const int key = key0 + 8 * j + 2 * qc + (el & 1);
          const int lim = el < 2 ? lim_a : lim_b;
          if (!(key < min(lim, kcap) && (window <= 0 || key >= lim - window))) x = -INFINITY;
        }
        sc[4 * j + el] = x;
      }
    // the four lanes of a quad share rows
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
    al_a = exp2f(m_a - mu_a);
    al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - mu_a);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mu_a);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mu_b);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mu_b);
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * al_a + sum_a;   // this lane's share of the row; the quad adds at the end
    l_b = l_b * al_b + sum_b;
  };
  // o *= alpha (skipped once the rows' maxima settle: alpha is 1), then P's
  // high and low bf16 parts as P V's A fragments: the S fragments of keys
  // 16 ks.. are P's
  auto rescale_and_pack = [&]() {
    if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        o[4 * d] *= al_a;
        o[4 * d + 1] *= al_a;
        o[4 * d + 2] *= al_b;
        o[4 * d + 3] *= al_b;
      }
    }
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16x2(sc[8 * ks4 + 2 * f], sc[8 * ks4 + 2 * f + 1], ph[ks4][f], pl[ks4][f]);
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  // The two warpgroups take turns to issue their wgmmas (named barriers 1
  // and 2), so that one's softmax runs while the other's products do.
  // Warpgroup 0 goes first; each step of either ends with the other's turn.
  auto turn_wait = [&]() { named_bar_sync(1 + wg, kPcConsumers); };
  auto turn_pass = [&]() { named_bar_arrive(2 - wg, kPcConsumers); };
  if (wg == 1) turn_pass();

  // Each warpgroup walks every tile of the block, so that the two take the
  // same turns and their releases keep the rings' phases; it multiplies the
  // first my_tiles. Step j issues S of the block's tile j + 1 and P V of
  // tile j, and the softmax of j + 1 runs while P V of j does.
  mbar_wait(full_q, 0);
  mbar_wait(full_k, 0);
  fence_proxy_async();
  turn_wait();
  if (my_tiles > 0) issue_s(0);
  turn_pass();
  wgmma_wait<0>();
  fence_acc(sc);
  release(empty_k);
  if (my_tiles > 0) {
    softmax(t_begin);
    rescale_and_pack();
  }
  auto issue_pv = [&](int st) {
    fence_frags(ph);
    fence_frags(pl);
    fence_acc(o);
    wgmma_fence();
    const uint32_t vt = smem_addr(vs + st * kPcTileBytes);
#pragma unroll
    for (int ks4 = 0; ks4 < kPcKeys / 16; ++ks4) {
      const uint64_t vd = sw128_desc_mn(vt + ks4 * 2 * kPcVGroupBytes, kPcVChunkBytes,
                                        kPcVGroupBytes);
      wgmma_rs_64x256_t(o, ph[ks4], vd);
      wgmma_rs_64x256_t(o, pl[ks4], vd);
    }
    wgmma_commit();
  };
  for (int j = 0; j < tiles; ++j) {
    const bool more = j + 1 < tiles;
    const int st = j % kPcStages, sn = (j + 1) % kPcStages;
    if (more) {
      mbar_wait(full_k + sn, ((j + 1) / kPcStages) & 1);
      fence_proxy_async();
    }
    turn_wait();
    if (j + 1 < my_tiles) {                        // S of j + 1, then P V of j
      issue_s(j + 1);
      mbar_wait(full_v + st, (j / kPcStages) & 1);
      fence_proxy_async();
      issue_pv(st);
      turn_pass();
      wgmma_wait<1>();                             // S of j + 1; P V of j runs on
      fence_acc(sc);
      release(empty_k + sn);
      softmax(t_begin + j + 1);
      wgmma_wait<0>();
      fence_acc(o);
      release(empty_v + st);
      rescale_and_pack();
    } else if (j < my_tiles) {                     // P V of this warpgroup's last tile
      mbar_wait(full_v + st, (j / kPcStages) & 1);
      fence_proxy_async();
      issue_pv(st);
      if (wg == 0 || more) turn_pass();
      wgmma_wait<0>();
      fence_acc(o);
      if (more) release(empty_k + sn);
      release(empty_v + st);
    } else {                                       // a tile past this warpgroup's rows
      mbar_wait(full_v + st, (j / kPcStages) & 1);
      if (wg == 0 || more) turn_pass();
      if (more) release(empty_k + sn);
      release(empty_v + st);
    }
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  // rows ra (o[4 d], o[4 d + 1]) and rb (o[4 d + 2], o[4 d + 3]): output, or
  // this split's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = h ? rb : ra;
    if (R >= nrows) continue;
    const float m = h ? m_b : m_a, l = h ? l_b : l_a;
    if (splits == 1) {
      const float inv = l == 0.f ? 1.f : 1.f / l;   // no visible key: o == 0
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + out_row(bi, kvh, R, g, q_len, nh) * HD + 2 * qc);
#pragma unroll
      for (int d = 0; d < 32; ++d)
        dst[4 * d] = pack_bf16x2(o[4 * d + 2 * h] * inv, o[4 * d + 2 * h + 1] * inv);
    } else {
      const size_t w = ws_row(bi, kvh, R, split, nkv, nrows, splits);
      float2* dst = reinterpret_cast<float2*>(ws_o + w * HD + 2 * qc);
#pragma unroll
      for (int d = 0; d < 32; ++d) dst[4 * d] = make_float2(o[4 * d + 2 * h], o[4 * d + 2 * h + 1]);
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

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rk_paged_combine_kernel(
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
      o += ws_o[(w0 + s) * HD + d] * f;
    }
  }
  out[out_row(bi, kvh, r, g, q_len, nh) * HD + d] = from_f32<T>(l == 0.f ? 0.f : o / l);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on f32 tiles in shared memory, one split
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kSStride = kKeys + 1;

template <int kR, int HD>
constexpr size_t f32_smem_bytes() {
  return ((size_t)kR * (HD + 1)          // q, padded rows: conflict-free column reads
          + (size_t)kKeys * (HD + 1)     // k
          + (size_t)kKeys * HD           // v
          + (size_t)kR * kSStride        // scores / probabilities
          + 3 * kR) * sizeof(float)      // m, l, alpha
         + (size_t)(kKeys + kR) * sizeof(int);  // key rows, row limits
}

template <int kR, int HD>
__global__ void __launch_bounds__(kF32Threads) rk_paged_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int q_len, int nh, int nkv, int P, int ps,
    int mp, float sm_scale, int window, float softcap, float* __restrict__ out) {
  constexpr int RI = kR / 16;               // rows per thread
  constexpr int CJ = HD / 16;               // columns per thread
  constexpr int kQkStride = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                         // [kR][kQkStride]
  float* ks = qs + kR * kQkStride;          // [kKeys][kQkStride]
  float* vs = ks + kKeys * kQkStride;       // [kKeys][HD]
  float* pr = vs + kKeys * HD;              // [kR][kSStride]
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
  for (int i = tid; i < kR * HD; i += kF32Threads) {
    const int r = i / HD, h = i % HD;
    const int R = row0 + r;
    qs[r * kQkStride + h] = R < nrows ? q[out_row(bi, kvh, R, g, q_len, nh) * HD + h] : 0.f;
  }
  if (tid < kR) {
    const int R = row0 + tid;
    lim_row[tid] = R < nrows ? length - q_len + R / g + 1 : 0;
    m_row[tid] = -INFINITY;
    l_row[tid] = 0.f;
  }

  float o[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[i][j] = 0.f;

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
    for (int i = tid; i < kKeys * HD; i += kF32Threads) {
      const int c = i / HD, h = i % HD;
      const int row = key_row[c];
      float kx = 0.f, vx = 0.f;
      if (row >= 0) {
        const size_t src = (plane + row) * HD + h;
        kx = k_pages[src];
        vx = v_pages[src];
      }
      ks[c * kQkStride + h] = kx;
      vs[c * HD + h] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; ++h) {
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
      for (int j = 0; j < CJ; ++j) o[i][j] *= alpha;
    }
    for (int c = 0; c < kKeys; ++c) {
      float vv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = pr[(ty + 16 * i) * kSStride + c];
#pragma unroll
        for (int j = 0; j < CJ; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
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
    const size_t dst = out_row(bi, kvh, R, g, q_len, nh) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) out[dst + tx + 16 * j] = o[i][j] * linv;
  }
}

template <int kR, int HD>
int launch_f32(const float* q, const float* k_pages, const float* v_pages,
               const int* page_idx, const int* lengths, int b, int q_len, int nh,
               int nkv, int P, int ps, int mp, float sm_scale, int window,
               float softcap, float* out, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes<kR, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      rk_paged_kernel<kR, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nrows = q_len * (nh / nkv);
  const dim3 grid((nrows + kR - 1) / kR, nkv, b);
  rk_paged_kernel<kR, HD><<<grid, kF32Threads, bytes, stream>>>(
      q, k_pages, v_pages, page_idx, lengths, q_len, nh, nkv, P, ps, mp, sm_scale,
      window, softcap, out);
  return (int)cudaGetLastError();
}

template <int HD>
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
    if constexpr (HD == 256) {
      err = cudaFuncSetAttribute(rk_paged_decode_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDecSmem256);
      if (err != cudaSuccess) return (int)err;
      rk_paged_decode_mma_kernel<<<dim3(splits, nkv, b), kThreads, kDecSmem256, stream>>>(
          q, k_pages, v_pages, page_idx, lengths, nh, nkv, P, ps, mp, keys_per_split,
          sm_scale, window, softcap, ws_ml, ws_o, out);
    } else if constexpr (HD == 128) {
      constexpr size_t bytes = dec_smem_bytes<HD>();
      err = cudaFuncSetAttribute(rk_paged_decode_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      rk_paged_decode_kernel<HD><<<dim3(splits, nkv, b), kThreads, bytes, stream>>>(
          q, k_pages, v_pages, page_idx, lengths, nh, nkv, P, ps, mp, keys_per_split,
          sm_scale, window, softcap, ws_ml, ws_o, out);
    } else {
      constexpr size_t bytes = narrow_smem_bytes<HD>();
      err = cudaFuncSetAttribute(rk_paged_decode_narrow_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      rk_paged_decode_narrow_kernel<HD><<<dim3(splits, nkv, b), kThreads, bytes, stream>>>(
          q, k_pages, v_pages, page_idx, lengths, nh, nkv, P, ps, mp, keys_per_split,
          sm_scale, window, softcap, ws_ml, ws_o, out);
    }
  } else if constexpr (HD == 256) {
    const int box = chunk_box_rows(ps);
    CUtensorMap map_k = {}, map_v = {};            // unread where no box fits
    if (box > 0) {
      err = bf16_panel_map(&map_k, k_pages, nkv, (long long)P * ps, (long long)P * ps, box);
      if (err == cudaSuccess)
        err = bf16_panel_map(&map_v, v_pages, nkv, (long long)P * ps, (long long)P * ps, box);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaFuncSetAttribute(rk_paged_chunk_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kPcSmem);
    if (err != cudaSuccess) return (int)err;
    const int row_tiles = (rows + kPcRows - 1) / kPcRows;
    rk_paged_chunk_wgmma_kernel<<<dim3(splits, nkv * b, row_tiles), kPcThreads, kPcSmem,
                                  stream>>>(
        q, map_k, map_v, k_pages, v_pages, page_idx, lengths, q_len, nh, nkv, P, ps, mp,
        keys_per_split, sm_scale, window, softcap, ws_ml, ws_o, out);
  } else {
    constexpr size_t bytes = ChunkShape<HD>::kSmemBytes;
    err = cudaFuncSetAttribute(rk_paged_chunk_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int row_tiles = (rows + kRows - 1) / kRows;
    rk_paged_chunk_kernel<HD><<<dim3(splits, nkv * b, row_tiles), kThreads, bytes, stream>>>(
        q, k_pages, v_pages, page_idx, lengths, q_len, nh, nkv, P, ps, mp,
        keys_per_split, sm_scale, window, softcap, ws_ml, ws_o, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  rk_paged_combine_kernel<__nv_bfloat16, HD><<<b * nkv * rows, HD, 0, stream>>>(
      ws_ml, ws_o, splits, rows, g, q_len, nh, nkv, out);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k_pages, const void* v_pages, const int* idx,
           const int* lens, int b, int q_len, int nh, int nkv, int P, int ps, int mp,
           float sm_scale, int window, float softcap, int dtype, int keys_per_split,
           void* workspace, void* out, cudaStream_t st) {
  if (dtype == 1) {
    // splits are whole tiles of the kernel the shapes take: 32 keys for
    // decode at HD 256, else 64
    const int unit = HD == 256 && q_len == 1 && nh / nkv <= kMaxG ? kDecKeys256 : kKeys;
    if (keys_per_split <= 0 || keys_per_split % unit) return (int)cudaErrorInvalidValue;
    return launch_bf16<HD>(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k_pages),
                           static_cast<const __nv_bfloat16*>(v_pages), idx, lens, b, q_len,
                           nh, nkv, P, ps, mp, sm_scale, window, softcap, keys_per_split,
                           static_cast<float*>(workspace), static_cast<__nv_bfloat16*>(out),
                           st);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pages);
  const float* vf = static_cast<const float*>(v_pages);
  float* of = static_cast<float*>(out);
  if (q_len * (nh / nkv) <= 16)
    return launch_f32<16, HD>(qf, kf, vf, idx, lens, b, q_len, nh, nkv, P, ps, mp, sm_scale,
                              window, softcap, of, st);
  return launch_f32<64, HD>(qf, kf, vf, idx, lens, b, q_len, nh, nkv, P, ps, mp, sm_scale,
                            window, softcap, of, st);
}

}  // namespace

extern "C" {

// q/out (b, q_len, nh, hd); k_pages/v_pages (nkv, P, ps, hd), hd 64, 96, 128
// or 256; page_idx (b, mp) int32; lengths (b,) int32; dtype 0 = float32 (one
// split), 1 = bfloat16; window 0 = off, softcap 0 = off. bf16:
// keys_per_split a multiple of 64 (of 32 for decode at hd 256), splits =
// ceil(mp * ps / keys_per_split);
// with more than one split the workspace holds b * nkv * q_len * (nh / nkv)
// * splits * (2 + hd) floats. Returns a cudaError_t.
int rk_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                       const void* page_idx, const void* lengths, int b,
                       int q_len, int nh, int nkv, int P, int ps, int mp, int hd,
                       float sm_scale, int window, float softcap, int dtype,
                       int keys_per_split, void* workspace, void* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(page_idx);
  const int* lens = static_cast<const int*>(lengths);
#define RK_PAGED(HD)                                                                    \
  if (hd == HD)                                                                         \
    return launch<HD>(q, k_pages, v_pages, idx, lens, b, q_len, nh, nkv, P, ps, mp,    \
                      sm_scale, window, softcap, dtype, keys_per_split, workspace, out, \
                      st);
  RK_PAGED(64)
  RK_PAGED(96)
  RK_PAGED(128)
  RK_PAGED(256)
#undef RK_PAGED
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
