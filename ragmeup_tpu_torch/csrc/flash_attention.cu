// Causal flash-attention forward with grouped-query heads for Hopper (sm_90a).
//
// Replaces the Pallas kernels ragmeup_tpu/ops/attention.py::_flash_gqa_kernel
// and ::_flash_kernel (the g = 1 case of the same function).
//
//   q (B, g, s, HD)   - the g query heads that share one kv head, 1 <= g <= 64
//   k, v (B, kv_len, HD)
//   out (B, g, s, HD): softmax(q k^T * sm_scale, causal) v per head
//
// HD is 128 (Llama, Mistral, Qwen) or 256 (Gemma). Query row at position p
// attends keys 0..p; keys past s (the unused tail of a KV cache, kv_len >=
// s) are never read. Prefill is bound by the two products (4 flops per
// (query, key) pair and head dim), not by memory: the score tile never
// leaves the SM.
//
// A block takes the query rows of one kv head: all g heads at bq = rows / g
// positions (rounded down), so each K/V tile is read once for the g heads
// that share it. Row r is head r / bq at position q0 + r % bq; where g does
// not divide the rows (Qwen2.5-7B's g = 7: 9 positions, 63 of 64 rows) the
// rows from g * bq on are idle: they load zeros and are never written.
// Blocks are issued with the most key tiles first.
//
// bf16 at HD 128 (rk_flash_gqa_mma_kernel<128>): 64-row blocks of four
// warps on mma.sync, the tensor cores.
// - Each warp keeps its 16 x 128 slice of q in registers (mma A fragments)
//   for the whole key walk. (The template's HD-256 branches, q read from
//   shared memory at each k-step and 32-key tiles, are no longer built.)
// - K and V stay bf16 in shared memory, 64 keys a tile, filled by a
//   two-stage ring of 16-byte cp.async copies: tile t + 1 is in flight
//   while tile t multiplies. Rows are padded by 16 bytes (272 bytes), so
//   ldmatrix reads them without bank conflicts (V through ldmatrix.trans as
//   the B operand of P V). Two blocks fit an SM (85 KB of shared memory).
// - S = q k^T accumulates in registers (mma.sync m16n8k16, f32); the online
//   softmax runs on those registers (row max and sum over the four lanes
//   that share a row, by shuffles), with sm_scale * log2(e) folded into
//   exp2f. The running sum l adds the f32 p; P is rounded to bf16 and
//   repacked, register to register, as the A operand of P V (the JAX
//   kernel's p.astype(v.dtype)), so P never touches shared memory.
// - Only tiles that reach past the block's first position are masked; tiles
//   past its last position are not visited.
// - The output is divided by l at the end (l == 0 -> 1, as the TPU kernel).
//
// bf16 at HD 256 (rk_flash_gqa_wgmma_kernel; Gemma-7B's g 1, Gemma-2-9B's
// g 2): bound by the products too (Gemma-7B's prefill, s 1024: 8.6 GFLOP,
// 8.7 us at 989 TFLOP/s, beside 10.0 us for its 33.6 MB). What held the
// mma.sync form back at this head dim: q and the 16 x 256 f32 accumulators
// did not fit a warp's registers, so q was re-read from shared memory
// every k-step and the key tile halved to 32. This kernel is built on the
// warpgroup products instead:
// - A block takes 128 rows (bq = 128 / g positions): two consumer
//   warpgroups of 64 rows and a producer warpgroup, which gives its
//   registers to the consumers (setmaxnreg: 40 and 2 x 232).
// - q (64 KB) and two stages each of K and V tiles (64 keys x 256, 32 KB)
//   sit in shared memory in 128-byte-swizzled panels of 64 columns: 192
//   KB, one block an SM. The producer copies q with cp.async and each K or
//   V tile with four TMA tensor copies (one thread; the descriptors map
//   keys past s to zeros), whose bytes complete the stage's "full"
//   mbarrier. Each consumer warp releases a stage on its "empty" mbarrier,
//   and the producer refills it after all eight have. K and V have rings
//   of their own, and no barrier of the whole block runs in the loop. (A
//   producer issuing 16-byte cp.async copies instead measured slower than
//   the block-synchronous ring this kernel replaced: the loads, not the
//   products, set its pace.)
// - S = q k^T is 16 wgmma m64n64k16 with both operands in shared memory (K
//   as it lies is K-major); the 64 x 64 f32 tile stays in the warpgroup's
//   registers, where the online softmax runs. P, rounded to bf16 (the JAX
//   kernel's p.astype(v.dtype)), is the register A operand of o += P V: 4
//   wgmma m64n256k16 with V, as it lies (keys x head dim), the transposed
//   (MN-major) B operand. o is 64 x 256 f32, 128 registers a thread.
// - Step t issues S of tile t + 1 and then P V of tile t; the softmax of
//   t + 1 runs while P V of t is on the tensor cores. The two warpgroups
//   take turns to issue their products (named barriers 1 and 2), so one's
//   softmax runs beside the other's products. o is rescaled only where a
//   row's maximum moved (alpha != 1 in the warp).
// - The causal tail: blocks of 128 rows issued longest-first; where the
//   card has SMs to spare in the one wave the blocks fill, the longest
//   q-blocks' keys are split over two blocks (ops/attention.py
//   wgmma_split_from). The first of the two to finish stores its partial
//   (o, m, l in f32) and marks it ready; the second merges it with its
//   own, each product and the sum rounded one by one, so the bits do not
//   depend on which is second, and writes the rows. At Gemma's prefill
//   shapes the 128 blocks leave 4 SMs, so nothing splits: the longest
//   block's 16 tiles set the time, against an average of 9.

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
// bf16 at HD 256: wgmma
// ---------------------------------------------------------------------------

constexpr int kWgHD = 256;
constexpr int kWgRows = 128;                          // query rows a block, 64 a warpgroup
constexpr int kWgKeys = 64;                           // keys a tile
constexpr int kWgConsumers = 256;                     // two warpgroups of 64 rows
constexpr int kWgConsumerWarps = kWgConsumers / 32;
constexpr int kWgProducers = 128;                     // and the producer warpgroup
constexpr int kWgThreads = kWgConsumers + kWgProducers;
// registers a thread: 168 at launch (65,536 over 384 threads); the producer
// gives its share to the consumers (2 x 232 + 40 = 3 x 168)
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
constexpr int kWgQBytes = kWgRows * kWgHD * 2;        // q: four 128-row panels
constexpr int kWgTileBytes = kWgKeys * kWgHD * 2;     // one K or V tile: four 64-row panels
constexpr int kWgStages = 2;                          // the K ring's and the V ring's
constexpr int kWgBars = 1 + 4 * kWgStages;            // q; full and empty of K and V
constexpr int kWgSmem = kWgQBytes + 2 * kWgStages * kWgTileBytes + 8 * kWgBars + 16 +
                        1024;                         // + the ticket's word, 1024-byte alignment
constexpr int kWgPartLd = kWgHD + 2;                  // floats a row of a split's partial: o, m, l
// V as wgmma's transposed B operand: 64-column chunks of hd one panel
// apart, groups of 8 keys one swizzle atom apart
constexpr uint32_t kVChunkBytes = kWgKeys * 128, kVGroupBytes = 1024;

__global__ void __launch_bounds__(kWgThreads, 1) rk_flash_gqa_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v, int g, int s, int kv_len, float scale_log2,
    int split_from, float* __restrict__ ws, unsigned* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + kWgQBytes;                  // [stage] K tiles
  unsigned char* vs = ks + kWgStages * kWgTileBytes;   // [stage] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kWgStages * kWgTileBytes);
  uint64_t* full_q = bars;                             // the producer's copies landed
  uint64_t* full_k = bars + 1;                         // [stage]
  uint64_t* full_v = full_k + kWgStages;
  uint64_t* empty_k = full_v + kWgStages;              // [stage]: every consumer warp is done
  uint64_t* empty_v = empty_k + kWgStages;

  const int bq = kWgRows / g;                      // positions per block
  const int used = g * bq;                         // rows that hold a (head, position)
  const int bkv = blockIdx.x;
  const int tid = threadIdx.x;
  // blockIdx.y: both pieces of each split q-block, longest first, then the
  // whole q-blocks below split_from, longest first
  const int nq = (s + bq - 1) / bq, n_split = nq - split_from;
  const int y = blockIdx.y;
  const int qb = y < 2 * n_split ? nq - 1 - y / 2 : split_from - 1 - (y - 2 * n_split);
  const int part = y < 2 * n_split ? y % 2 : -1;   // the keys' first or second half, or all
  const int q0 = qb * bq;
  const int last_key = min(min(q0 + bq, s), kv_len);  // exclusive
  const int all_tiles = (last_key + kWgKeys - 1) / kWgKeys;
  const int half = (all_tiles + 1) / 2;
  const int t_begin = part == 1 ? half : 0;
  const int tiles = (part == 0 ? half : all_tiles) - t_begin;   // this block's, from t_begin

  if (tid == 0) {
    mbar_init(full_q, kWgProducers);
#pragma unroll
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty_k + st, kWgConsumerWarps);
      mbar_init(empty_v + st, kWgConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    // the producer warpgroup: q once, then K and V tile by tile into their
    // rings, a stage refilled once every consumer warp has released it
    setmaxnreg_dec<kWgProducerRegs>();
    const int lane = tid - kWgConsumers;
    for (int i = lane; i < kWgRows * 32; i += kWgProducers) {
      // row r of the block: head r / bq at position q0 + r % bq
      const int r = i / 32, c = i % 32;
      const int pos = q0 + r % bq;
      const bool ok = r < used && pos < s;
      cp_async16(qs + panel_off(r, c, kWgRows),
                 q + (((size_t)bkv * g + (ok ? r / bq : 0)) * s + (ok ? pos : 0)) * kWgHD + c * 8,
                 ok);
    }
    cp_async_mbar_arrive(full_q);
    if (lane == 0) {
      for (int j = 0; j < tiles; ++j) {
        const int st = j % kWgStages, use = j / kWgStages, key0 = (t_begin + j) * kWgKeys;
        if (use > 0) mbar_wait(empty_k + st, (use - 1) & 1);
        mbar_expect_tx(full_k + st, kWgTileBytes);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load_3d(ks + st * kWgTileBytes + p * kWgKeys * 128, &tmap_k, 64 * p, key0, bkv,
                      full_k + st);
        if (use > 0) mbar_wait(empty_v + st, (use - 1) & 1);
        mbar_expect_tx(full_v + st, kWgTileBytes);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load_3d(vs + st * kWgTileBytes + p * kWgKeys * 128, &tmap_v, 64 * p, key0, bkv,
                      full_v + st);
      }
    }
    cp_async_wait<0>();
    return;
  }

  setmaxnreg_inc<kWgConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;
  // this warpgroup's rows 64 wg .. r_hi: the key tiles they reach and the
  // first position (tiles past it need the causal mask)
  const int r_lo = 64 * wg, r_hi = min(r_lo + 64, used) - 1;
  const bool one_head = r_lo / bq == r_hi / bq;
  const int lo_pos = q0 + (one_head ? r_lo % bq : 0);
  const int hi_key = min(min(q0 + (one_head ? r_hi % bq : bq - 1) + 1, s), kv_len);
  // the tiles of this block it multiplies: 0 .. my_tiles - 1 from t_begin
  const int my_tiles = max(0, min((hi_key + kWgKeys - 1) / kWgKeys, t_begin + tiles) - t_begin);
  // this thread's rows of the accumulators: ra and ra + 8
  const int ra = r_lo + 16 * warp + gr, rb = ra + 8;
  const int pos_a = q0 + ra % bq, pos_b = q0 + rb % bq;
  const uint32_t q_desc = smem_addr(qs) + r_lo * 128;  // the warpgroup's 64 rows of each panel

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;                    // the next P V's rescale of o
  float sc[32];
  uint32_t pa[4][4];

  // S = q k^T of the block's j-th tile into sc: 64 rows x 64 keys, 16
  // k-steps over the panels
  auto issue_s = [&](int j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
    const uint32_t kt = smem_addr(ks + (j % kWgStages) * kWgTileBytes);
#pragma unroll
    for (int kk = 0; kk < kWgHD / 16; ++kk)
      wgmma_ss_64x64(sc, sw128_desc(q_desc + (kk >> 2) * (kWgRows * 128) + (kk & 3) * 32),
                     sw128_desc(kt + (kk >> 2) * (kWgKeys * 128) + (kk & 3) * 32));
    wgmma_commit();
  };
  // the online softmax of key tile t on sc (scaled into the log2 domain,
  // masked where the tile reaches past lo_pos): p in sc, l updated, alpha kept
  auto softmax = [&](int t) {
    const int key0 = t * kWgKeys;
    const bool diag = key0 + kWgKeys - 1 > lo_pos;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (diag && key0 + 8 * j + 2 * qc + (e & 1) > (e < 2 ? pos_a : pos_b)) x = -INFINITY;
        sc[4 * j + e] = x;
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
  // o *= alpha (skipped once the rows' maxima settle: alpha is 1), then
  // bf16(P) as P V's A fragments: the S fragments of keys 16 ks.. are P's
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
    for (int ks4 = 0; ks4 < 4; ++ks4) {
      pa[ks4][0] = pack_bf16x2(sc[8 * ks4], sc[8 * ks4 + 1]);
      pa[ks4][1] = pack_bf16x2(sc[8 * ks4 + 2], sc[8 * ks4 + 3]);
      pa[ks4][2] = pack_bf16x2(sc[8 * ks4 + 4], sc[8 * ks4 + 5]);
      pa[ks4][3] = pack_bf16x2(sc[8 * ks4 + 6], sc[8 * ks4 + 7]);
    }
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  // The two warpgroups take turns to issue their wgmmas (named barriers 1
  // and 2), so that one's softmax runs while the other's products do.
  // Warpgroup 0 goes first; each step of either ends with the other's turn.
  auto turn_wait = [&]() { named_bar_sync(1 + wg, kWgConsumers); };
  auto turn_pass = [&]() { named_bar_arrive(2 - wg, kWgConsumers); };
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
    fence_frags(pa);
    fence_acc(o);
    wgmma_fence();
    const uint32_t vt = smem_addr(vs + st * kWgTileBytes);
#pragma unroll
    for (int ks4 = 0; ks4 < kWgKeys / 16; ++ks4)
      wgmma_rs_64x256_t(o, pa[ks4], sw128_desc_mn(vt + ks4 * 2 * kVGroupBytes, kVChunkBytes,
                                                  kVGroupBytes));
    wgmma_commit();
  };
  for (int j = 0; j < tiles; ++j) {
    const bool more = j + 1 < tiles;
    const int st = j % kWgStages, sn = (j + 1) % kWgStages;
    if (more) {
      mbar_wait(full_k + sn, ((j + 1) / kWgStages) & 1);
      fence_proxy_async();
    }
    turn_wait();
    if (j + 1 < my_tiles) {                        // S of j + 1, then P V of j
      issue_s(j + 1);
      mbar_wait(full_v + st, (j / kWgStages) & 1);
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
      mbar_wait(full_v + st, (j / kWgStages) & 1);
      fence_proxy_async();
      issue_pv(st);
      if (wg == 0 || more) turn_pass();
      wgmma_wait<0>();
      fence_acc(o);
      if (more) release(empty_k + sn);
      release(empty_v + st);
    } else {                                       // a tile past this warpgroup's rows
      mbar_wait(full_v + st, (j / kWgStages) & 1);
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
  if (part >= 0) {
    // A split q-block: the first of its two pieces to finish stores its
    // partial (o, m, l in f32) and marks it ready; the second merges it
    // with its own, o = o_1 f_1 + o_2 f_2 with f_i = exp2(m_i - max m),
    // products and sum rounded one by one, so the bits are the same
    // whichever piece comes second. The second resets both ticket words.
    unsigned* ticket = tickets + 2 * ((size_t)bkv * n_split + (nq - 1 - qb));
    float* part_o = ws + ((size_t)bkv * n_split + (nq - 1 - qb)) * kWgRows * kWgPartLd;
    unsigned* first = reinterpret_cast<unsigned*>(bars + kWgBars);
    named_bar_sync(3, kWgConsumers);
    if (tid == 0) *first = atomicAdd(ticket, 1u) == 0;
    named_bar_sync(3, kWgConsumers);
    if (*first) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = part_o + (size_t)(h ? rb : ra) * kWgPartLd;
#pragma unroll
        for (int d = 0; d < 32; ++d)
          *reinterpret_cast<float2*>(row + 8 * d + 2 * qc) =
              make_float2(o[4 * d + 2 * h], o[4 * d + 2 * h + 1]);
        if (qc == 0)
          *reinterpret_cast<float2*>(row + kWgHD) = make_float2(h ? m_b : m_a, h ? l_b : l_a);
      }
      __threadfence();
      named_bar_sync(3, kWgConsumers);
      if (tid == 0) atomicExch(ticket + 1, 1u);
      return;
    }
    if (tid == 0)
      while (atomicAdd(ticket + 1, 0u) == 0) __nanosleep(64);
    named_bar_sync(3, kWgConsumers);
    __threadfence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = part_o + (size_t)(h ? rb : ra) * kWgPartLd;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(row + kWgHD));
      float& m = h ? m_b : m_a;
      float& l = h ? l_b : l_a;
      const float mx = fmaxf(m, ml.x);
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float f_mine = exp2f(m - mu), f_other = exp2f(ml.x - mu);
      l = __fadd_rn(__fmul_rn(l, f_mine), __fmul_rn(ml.y, f_other));
      m = mx;
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        const float2 other = __ldcg(reinterpret_cast<const float2*>(row + 8 * d + 2 * qc));
        o[4 * d + 2 * h] = __fadd_rn(__fmul_rn(o[4 * d + 2 * h], f_mine),
                                     __fmul_rn(other.x, f_other));
        o[4 * d + 2 * h + 1] = __fadd_rn(__fmul_rn(o[4 * d + 2 * h + 1], f_mine),
                                         __fmul_rn(other.y, f_other));
      }
    }
    if (tid == 0) {
      atomicExch(ticket, 0u);
      atomicExch(ticket + 1, 0u);
    }
  }
  const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
  if (ra < used && pos_a < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + ra / bq) * s + pos_a) * kWgHD + 2 * qc);
#pragma unroll
    for (int d = 0; d < 32; ++d) dst[4 * d] = pack_bf16x2(o[4 * d] * inv_a, o[4 * d + 1] * inv_a);
  }
  if (rb < used && pos_b < s) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + (((size_t)bkv * g + rb / bq) * s + pos_b) * kWgHD + 2 * qc);
#pragma unroll
    for (int d = 0; d < 32; ++d) dst[4 * d] = pack_bf16x2(o[4 * d + 2] * inv_b, o[4 * d + 3] * inv_b);
  }
}


// (bkv, rows, 256) bf16 with rows kv_len apart: boxes of 64 keys x 64
// columns (one swizzled panel), keys from `rows` on read as zeros
cudaError_t kv_map(CUtensorMap* map, const void* base, int bkv, int rows, int kv_len) {
  return bf16_panel_map(map, base, bkv, rows, kv_len, kWgKeys);
}

int launch_wgmma(const void* q, const void* k, const void* v, int bkv, int g, int s,
                 int kv_len, float sm_scale, int split_from, float* ws, unsigned* tickets,
                 void* out, cudaStream_t st) {
  const int bq = kWgRows / g, nq = (s + bq - 1) / bq;
  if (split_from < 0 || split_from > nq) return (int)cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  const int rows = min(s, kv_len);                 // keys past s are never needed
  cudaError_t err = kv_map(&map_k, k, bkv, rows, kv_len);
  if (err == cudaSuccess) err = kv_map(&map_v, v, bkv, rows, kv_len);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rk_flash_gqa_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return (int)err;
  rk_flash_gqa_wgmma_kernel<<<dim3(bkv, nq + (nq - split_from)), kWgThreads, kWgSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), map_k, map_v, g, s, kv_len,
      sm_scale * 1.4426950408889634f, split_from, ws, tickets,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
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
           float sm_scale, int dtype, int split_from, float* ws, unsigned* tickets, void* out,
           cudaStream_t st) {
  const int bq = kRows / g;
  const int qblocks = (s + bq - 1) / bq;
  if constexpr (HD == kWgHD) {
    if (dtype == 1)
      return launch_wgmma(q, k, v, bkv, g, s, kv_len, sm_scale, split_from, ws, tickets, out,
                          st);
  } else if (dtype == 1) {
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
// (tensor-core kernel). bf16 at hd 256 only: the 128-row q-blocks from
// split_from on (of ceil(s / (128 / g))) are split in two pieces over their
// keys, with ws holding bkv * (q-blocks - split_from) * 128 * 258 floats and
// tickets twice as many zeroed words (left zero); split_from = the q-blocks
// splits none. Returns a cudaError_t.
int rk_flash_gqa(const void* q, const void* k, const void* v, int bkv, int g,
                 int s, int kv_len, int hd, float sm_scale, int dtype, int split_from,
                 void* ws, void* tickets, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  unsigned* t = static_cast<unsigned*>(tickets);
  if (g < 1 || g > kRows) return (int)cudaErrorInvalidValue;
  if (hd == 128)
    return launch<128>(q, k, v, bkv, g, s, kv_len, sm_scale, dtype, split_from, w, t, out, st);
  if (hd == 256)
    return launch<256>(q, k, v, bkv, g, s, kv_len, sm_scale, dtype, split_from, w, t, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
