// Fused dense scoring + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernels ragmeup_tpu/ops/topk.py::_topk_kernel (bf16
// or f32 corpus) and ::_topk_int8_kernel (int8 codes with per-column
// scales). Those walk the corpus in order on one TPU core and carry a
// running (b, k) top-k in VMEM from one grid step to the next. Here:
//
//   rk_topk_kernel: a block takes a group of up to 64 query rows and a
//     contiguous run of 128-column tiles (ops/topk.py::topk_plan sizes the
//     grid from the SM count, so N = 16,384 already fills the card). The
//     corpus streams through an 8-stage ring of 16-byte cp.async copies into
//     a 128-byte-swizzled k-major tile, read by ldmatrix.trans. The scores
//     run on the tensor cores with the corpus as the 16-row A operand and
//     the queries, staged once in shared memory, as the 8-wide B operand:
//     bf16 on mma.sync m16n8k16 (f32 sums); int8 on mma.sync m16n8k32 s8
//     (exact int32 sums), its A fragments made from ldmatrix.trans's byte
//     pairs by two PRMTs (fragment row g holds even column 2g, row g + 8
//     the odd one; the k order inside each 16 is permuted, and the queries
//     are staged in the same order). An f32 corpus keeps a CUDA-core
//     product (TF32 would change the scores) in the same fragment layout.
//     A tile's scores go to shared memory; each query row is then owned
//     by one warp, which keeps the row's ranked list of the best KP >= k
//     (score, index) pairs seen and reads its k-th entry as a threshold.
//     The block's first tile is sorted whole (128 entries) into the list;
//     after it a score enters the row's buffer of KP slots only if it
//     ranks before the threshold, 32 at a time, compacted by a ballot; a
//     buffer that would overflow (and the block's end) is bitonic-sorted
//     by the warp and merged into the list. The block writes k candidates
//     a row.
//   merge_candidates: the warps of a block run the same selection over
//     strided shares of a query row's blocks x k candidates (only those at
//     or before the best of the blocks' k-th entries), combine their lists
//     pairwise, and write the k best. Either a second launch,
//     rk_topk_merge_kernel, runs it with eight warps a row, or (a ticket
//     a row group given) the last block of each row group to finish runs
//     it with its four warps for each of its rows in turn; ops/topk.py's
//     plan takes the last block for a single query only. A call is at most
//     two launches (one when a single block covers the columns).
//
// The int8 entry also quantizes the f32 queries in the kernel (per row:
// scale = max(amax, 1e-8) / 127, codes rint(x / scale) clamped to +-127,
// both divisions correctly rounded: ops/topk.py::quantize_int8 to the bit),
// so no host value enters a call and it can be captured in a CUDA graph.
// Its epilogue keeps the TPU kernel's order, (float)acc * q_scale *
// c_scale + mask, one rounding a step (no FMA contraction).
//
// Bound: reading the corpus once (b small), or the 2 b d N products at
// large b (S3 of chip_smoke.py). The (b x N) scores never reach device
// memory, and no sort takes more than 128 entries.
//
// Semantics kept from the TPU kernel: ties break to the lowest index; dead
// and padding columns carry the additive mask value -1e30, and a slot that
// no live column fills comes out as (-1e30, -1).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 128;         // corpus columns a block scores at once
constexpr int kThreads = 128;      // 4 warps; warp w owns the 32 columns 32w..32w+31
constexpr int kStages = 8;         // cp.async ring depth
constexpr int kStageBytes = 8192;  // kTile columns of 16 f32, 32 bf16 or 64 int8 rows
constexpr int kScoreStride = kTile + 4;  // floats a row of a tile's staged scores
constexpr int kWarps = kThreads / 32;
constexpr int kQBatch = 8;     // 16-byte query loads a thread keeps in flight
constexpr int kRowBatch = 4;   // query rows a warp tests at once after a tile
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;  // ragmeup_tpu.ops.topk.NEG_INF
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// (sa, ia) ranks before (sb, ib): higher score first, then lower index.
__device__ __forceinline__ bool ranks_before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Writes one ranked slot, mapping "never filled by a live column" to the
// TPU kernel's (-1e30, -1).
__device__ __forceinline__ void emit(float s, int i, float* out_s, int* out_i) {
  if (s <= kNegInf) {
    s = kNegInf;
    i = -1;
  }
  *out_s = s;
  *out_i = i;
}

// ---------------------------------------------------------------------------
// Selection: a query row's ranked list of kp pairs (best first) and buffer
// of kp unranked candidates in shared memory, owned by one warp.
// ---------------------------------------------------------------------------

struct RowSel {
  float* ls;  // [kp] ranked scores
  int* li;    // [kp] ranked indices
  float* bs;  // [kp] buffered scores
  int* bi;    // [kp]
};

// the selection of row `row` among those laid out from p
__device__ RowSel row_sel(char* p, int row, int kp) {
  float* base = reinterpret_cast<float*>(p) + (size_t)row * kp * 4;
  return {base, reinterpret_cast<int*>(base + kp), base + 2 * kp,
          reinterpret_cast<int*>(base + 3 * kp)};
}
__host__ __device__ constexpr size_t sel_bytes(int rows, int kp) {
  return (size_t)rows * kp * 16;
}
// block-collective: every list of `rows` empty (no entry ranks after these)
__device__ void clear_lists(char* p, int rows, int kp) {
  for (int i = threadIdx.x; i < rows * kp; i += blockDim.x) {
    const RowSel R = row_sel(p, i / kp, kp);
    R.ls[i % kp] = -INFINITY;
    R.li[i % kp] = kIntMax;
  }
}

// One compare-exchange of a warp-wide bitonic network over n = 32 E
// entries, entry e * 32 + lane in register e: the lower position of each
// pair keeps the better entry where `best_first` holds for it.
template <int E>
__device__ __forceinline__ void bitonic_step(float (&s)[E], int (&id)[E], int size, int stride) {
  const int lane = threadIdx.x & 31;
  if (stride >= 32) {
    const int es = stride >> 5;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & es) continue;
      const int e2 = e | es;
      const bool best_first = ((e * 32) & size) == 0;
      const bool swap = best_first ? ranks_before(s[e2], id[e2], s[e], id[e])
                                   : ranks_before(s[e], id[e], s[e2], id[e2]);
      if (swap) {
        const float ts = s[e];
        const int ti = id[e];
        s[e] = s[e2];
        id[e] = id[e2];
        s[e2] = ts;
        id[e2] = ti;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float os = __shfl_xor_sync(kFull, s[e], stride);
      const int oi = __shfl_xor_sync(kFull, id[e], stride);
      const bool lower = (lane & stride) == 0;
      const bool best_first = ((e * 32 + lane) & size) == 0;
      if ((lower == best_first) == ranks_before(os, oi, s[e], id[e])) {
        s[e] = os;
        id[e] = oi;
      }
    }
  }
}

// A warp's 32 E entries sorted best first (entry e * 32 + lane in register e).
template <int E>
__device__ __forceinline__ void warp_sort(float (&s)[E], int (&id)[E]) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step<E>(s, id, size, stride);
}

// One warp merges a row's buffer (n <= kp = 32 E entries) into its ranked
// list: sort the buffer best first, take the better of list[i] and
// buffer[kp - 1 - i] (the best kp of both, a bitonic sequence), and sort
// that with one bitonic merge.
template <int E>
__device__ void merge_row(float* ls, int* li, const float* bs, const int* bi, int n) {
  constexpr int kp = 32 * E;
  const int lane = threadIdx.x & 31;
  float s[E];
  int id[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    s[e] = i < n ? bs[i] : -INFINITY;
    id[e] = i < n ? bi[i] : kIntMax;
  }
  warp_sort<E>(s, id);
  float rs[E];  // buffer[kp - 1 - i]: register E - 1 - e of lane 31 - lane
  int ri[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    rs[e] = __shfl_sync(kFull, s[E - 1 - e], 31 - lane);
    ri[e] = __shfl_sync(kFull, id[E - 1 - e], 31 - lane);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float l_s = ls[e * 32 + lane];
    const int l_i = li[e * 32 + lane];
    const bool list_better = ranks_before(l_s, l_i, rs[e], ri[e]);
    s[e] = list_better ? l_s : rs[e];
    id[e] = list_better ? l_i : ri[e];
  }
#pragma unroll
  for (int stride = kp >> 1; stride > 0; stride >>= 1) bitonic_step<E>(s, id, 2 * kp, stride);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ls[e * 32 + lane] = s[e];
    li[e * 32 + lane] = id[e];
  }
  __syncwarp();
}

// (s, i) ranks before the row's k-th best so far
__device__ __forceinline__ bool passes(const RowSel& R, int k, float s, int i) {
  return ranks_before(s, i, R.ls[k - 1], R.li[k - 1]);
}

// Warp-collective merge of the row's n buffered entries into its list (out
// of line: every offer may call it, and inlined copies bloat the build).
__device__ __noinline__ void merge_buffer(const RowSel& R, int kp, int n) {
  if (kp == 32) merge_row<1>(R.ls, R.li, R.bs, R.bi, n);
  else if (kp == 64) merge_row<2>(R.ls, R.li, R.bs, R.bi, n);
  else merge_row<4>(R.ls, R.li, R.bs, R.bi, n);
}

// Warp-collective: the lanes with `want` offer (s, i) to the row, whose
// buffer holds `cnt` entries; returns the new count. An offer enters only
// if it ranks before the row's k-th best; a buffer that would overflow is
// merged into the list first and the offers tested again.
__device__ int offer(const RowSel& R, int k, int kp, int cnt, float s, int i, bool want) {
  want = want && passes(R, k, s, i);
  unsigned m = __ballot_sync(kFull, want);
  if (m == 0) return cnt;
  if (cnt + __popc(m) > kp) {
    merge_buffer(R, kp, cnt);
    cnt = 0;
    want = want && passes(R, k, s, i);
    m = __ballot_sync(kFull, want);
  }
  const int lane = threadIdx.x & 31;
  if (want) {
    const int pos = cnt + __popc(m & ((1u << lane) - 1u));
    R.bs[pos] = s;
    R.bi[pos] = i;
  }
  __syncwarp();
  return cnt + __popc(m);
}

// Warp-collective: a tile's 128 scores of one row (columns col0 ..) sorted,
// and the best kp made the row's list (which held nothing yet).
__device__ void sort_into_list(const RowSel& R, int kp, const float* scores, int col0) {
  const int lane = threadIdx.x & 31;
  float s[4];
  int id[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] = scores[32 * e + lane];
    id[e] = col0 + 32 * e + lane;
  }
  warp_sort<4>(s, id);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (32 * e < kp) {
      R.ls[32 * e + lane] = s[e];
      R.li[32 * e + lane] = id[e];
    }
  __syncwarp();
}

// The k best of a query row's blocks x k candidates (cs, ci), by the W
// warps of the block (block-collective: blockDim.x == 32 W, every thread
// calls it). Each block's list holds k candidates ranking at or before its
// k-th, so the best of the blocks' k-th entries ranks at or after the
// row's k-th best: only candidates at or before it are offered. Warp w
// selects from candidates w * 32 + lane + 32 W u; then, halving, warp w
// takes in the best k of warp w + W / 2, ..., w + 1. sel holds W
// selections, cut 2 W words. Candidates are read through L2 (__ldcg):
// under the last-block route other blocks of the same launch wrote them.
template <int W>
__device__ __noinline__ void merge_candidates(const float* cs, const int* ci, int blocks, int k,
                                              int kp, char* sel, float* cut, float* out_s,
                                              int* out_i) {
  const int m = blocks * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* cut_s = cut;
  int* cut_i = reinterpret_cast<int*>(cut + W);
  clear_lists(sel, W, kp);
  float ks = -INFINITY;
  int ki = kIntMax;
  for (int p = threadIdx.x; p < blocks; p += 32 * W) {
    const float s = __ldcg(cs + p * k + k - 1);
    const int i = __ldcg(ci + p * k + k - 1);
    if (ranks_before(s, i, ks, ki)) {
      ks = s;
      ki = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s = __shfl_xor_sync(kFull, ks, o);
    const int i = __shfl_xor_sync(kFull, ki, o);
    if (ranks_before(s, i, ks, ki)) {
      ks = s;
      ki = i;
    }
  }
  if (lane == 0) {
    cut_s[warp] = ks;
    cut_i[warp] = ki;
  }
  __syncthreads();
  for (int w = 0; w < W; ++w)
    if (ranks_before(cut_s[w], cut_i[w], ks, ki)) {
      ks = cut_s[w];
      ki = cut_i[w];
    }

  constexpr int J = 8;  // candidates a lane loads at once
  const RowSel mine = row_sel(sel, warp, kp);
  int n_buf = 0;
  for (int base = warp * 32; base < m; base += J * 32 * W) {
    float s[J];
    int id[J];
#pragma unroll
    for (int u = 0; u < J; ++u) {
      const int j = base + u * 32 * W + lane;
      s[u] = j < m ? __ldcg(cs + j) : -INFINITY;
      id[u] = j < m ? __ldcg(ci + j) : kIntMax;
    }
#pragma unroll
    for (int u = 0; u < J; ++u)
      n_buf = offer(mine, k, kp, n_buf, s[u], id[u],
                    id[u] != kIntMax && !ranks_before(ks, ki, s[u], id[u]));
  }
  if (n_buf > 0) merge_buffer(mine, kp, n_buf);
  for (int half = W / 2; half > 0; half >>= 1) {  // warp w takes warp w + half's best k
    __syncthreads();
    if (warp < half) {
      const RowSel other = row_sel(sel, warp + half, kp);
      n_buf = 0;
      for (int t0 = 0; t0 < k; t0 += 32) {
        const int t = t0 + lane;
        n_buf = offer(mine, k, kp, n_buf, t < k ? other.ls[t] : -INFINITY,
                      t < k ? other.li[t] : kIntMax, t < k);
      }
      if (n_buf > 0) merge_buffer(mine, kp, n_buf);
    }
  }
  if (warp == 0)
    for (int t = lane; t < k; t += 32) emit(mine.ls[t], mine.li[t], out_s + t, out_i + t);
  __syncthreads();  // sel and cut are free again
}

// ---------------------------------------------------------------------------
// Scores of a 128-column tile: warp w, m-tiles 2w and 2w + 1 (16 columns
// each), NT n-tiles of 8 query rows. Lane 4 g + c holds, for each (m-tile,
// n-tile), rows 2c and 2c + 1 (e & 1) of columns col_in_tile(e >> 1).
// ---------------------------------------------------------------------------

template <typename T> struct Tiling;

template <> struct Tiling<float> {
  static constexpr int kRows = kStageBytes / (kTile * 4);  // 16 k rows a stage
  using Acc = float;
  // column within an m-tile of the fragment row g (h = 0) or g + 8 (h = 1)
  __device__ static int col(int g, int h) { return g + 8 * h; }
};
template <> struct Tiling<__nv_bfloat16> {
  static constexpr int kRows = kStageBytes / (kTile * 2);  // 32
  using Acc = float;
  __device__ static int col(int g, int h) { return g + 8 * h; }
};
template <> struct Tiling<int8_t> {
  static constexpr int kRows = kStageBytes / kTile;  // 64
  using Acc = int;
  __device__ static int col(int g, int h) { return 2 * g + h; }  // even, odd column
};

// byte offset in a stage of 16-byte chunk `ch` of k row `r` (XOR swizzle:
// eight consecutive rows' chunk ch sit in eight different bank groups)
__device__ __forceinline__ int swz(int r, int ch, int row_bytes) {
  return r * row_bytes + ((ch ^ (r & 7)) << 4);
}

// logical k position of physical k p within a 16-row block of the int8
// product: fragment byte j of lane c reads physical rows 2c, 2c + 1, 8 + 2c,
// 9 + 2c (ldmatrix.trans pairs), so the staged queries follow that order
__device__ __forceinline__ int int8_kpos(int p) {
  return (p & ~15) + 4 * ((p & 7) >> 1) + (p & 1) + (((p >> 3) & 1) << 1);
}

template <typename T, int NT>
__device__ __forceinline__ void tile_product(
    const char* stage, const char* qs, int qstride, int kbase,
    typename Tiling<T>::Acc (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int kk = 0; kk < Tiling<T>::kRows; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mt = 2 * warp + mi;
        const int j = lane >> 3, r = kk + ((j >> 1) << 3) + (lane & 7);
        ldmatrix_x4_trans(a[mi], stage + swz(r, 2 * mt + (j & 1), kTile * 2));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const char* qrow = qs + (size_t)(nt * 8 + g) * qstride + (size_t)(kbase + kk + 2 * c) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qrow + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][nt], a[mi], b0, b1);
      }
    }
  } else if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int kk = 0; kk < Tiling<T>::kRows; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t r4[4];
        const int r = kk + lane;  // matrix lane / 8 holds k rows 8 (lane / 8) ..
        ldmatrix_x4_trans(r4, stage + swz(r, 2 * warp + mi, kTile));
        a[mi][0] = __byte_perm(r4[0], r4[1], 0x6420);  // row g (column 2g), k 0-15
        a[mi][1] = __byte_perm(r4[0], r4[1], 0x7531);  // row g + 8 (column 2g + 1)
        a[mi][2] = __byte_perm(r4[2], r4[3], 0x6420);  // k 16-31
        a[mi][3] = __byte_perm(r4[2], r4[3], 0x7531);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const char* qrow = qs + (size_t)(nt * 8 + g) * qstride + kbase + kk + 4 * c;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qrow + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][nt], a[mi], b0, b1);
      }
    }
  } else {  // f32 on the CUDA cores, k in order
    const float* qf = reinterpret_cast<const float*>(qs);
    const int qs_f = qstride / 4;
#pragma unroll 4
    for (int r = 0; r < Tiling<T>::kRows; ++r) {
      float v[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (2 * warp + mi) * 16 + g + 8 * h;
          v[mi][h] = *reinterpret_cast<const float*>(stage + swz(r, col >> 2, kTile * 4) +
                                                     (col & 3) * 4);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float qv = qf[(nt * 8 + 2 * c + p) * qs_f + kbase + r];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc[mi][nt][2 * h + p] = fmaf(qv, v[mi][h], acc[mi][nt][2 * h + p]);
        }
    }
  }
}

// staged query bytes a row: the k extent rounded to 64 plus a pad that
// keeps the B-fragment reads of the 8 rows of an n-tile on distinct banks
template <typename T> __host__ __device__ constexpr int q_row_bytes(int d64) {
  return d64 * (int)sizeof(T) + 16;
}

// ops/topk.py::topk_smem computes the same
template <typename T>
size_t score_smem(int rows, int d, int kp) {
  const int d64 = (d + 63) / 64 * 64;
  return (size_t)kStages * kStageBytes + (size_t)rows * q_row_bytes<T>(d64) + (size_t)rows * 4 +
         (size_t)rows * kScoreStride * 4 + sel_bytes(rows, kp) + (size_t)rows * 4;
}

// q (b, d) f32; corpus_t (d, n); rows query rows a block (8 NT), blocks
// column blocks a row group; cand (b, blocks, k) or, with one block, out
// (b, k) directly. With `ticket` (a word a row group, zero at the launch),
// the last block of a row group to finish merges the group's candidates
// into out and leaves its word zero again.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) rk_topk_kernel(
    const float* __restrict__ q, const T* __restrict__ corpus_t,
    const float* __restrict__ c_scale, const float* __restrict__ mask, int b, int d, int n,
    int k, int kp, float* __restrict__ cand_s, int* __restrict__ cand_i,
    float* __restrict__ out_s, int* __restrict__ out_i, unsigned* __restrict__ ticket) {
  constexpr int R = 8 * NT;
  constexpr int KR = Tiling<T>::kRows;
  constexpr int kRowBytes = kTile * (int)sizeof(T);
  constexpr int kChunksPerRow = kRowBytes / 16;
  using Acc = typename Tiling<T>::Acc;
  extern __shared__ __align__(128) char smem[];
  char* ring = smem;
  const int d64 = (d + 63) / 64 * 64;
  const int qstride = q_row_bytes<T>(d64);
  char* qs = ring + kStages * kStageBytes;
  float* q_scale = reinterpret_cast<float*>(qs + (size_t)R * qstride);
  float* st = q_scale + R;  // [R][kScoreStride] a tile's scores
  char* sel = reinterpret_cast<char*>(st + R * kScoreStride);
  int* cnt = reinterpret_cast<int*>(sel + sel_bytes(R, kp));  // [R] buffered entries

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int blocks = gridDim.x, p = blockIdx.x;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, b - row0);
  const long long tiles = n / kTile;
  const int t0 = (int)(tiles * p / blocks), t1 = (int)(tiles * (p + 1) / blocks);
  const int ksteps = d64 / KR;  // ring stages a tile
  const int total = (t1 - t0) * ksteps;

  auto load_stage = [&](int s) {
    if (s < total) {
      const int col0 = (t0 + s / ksteps) * kTile;
      const int kr0 = (s % ksteps) * KR;
      char* stage = ring + (s % kStages) * kStageBytes;
      for (int ch = tid; ch < KR * kChunksPerRow; ch += kThreads) {
        const int r = ch / kChunksPerRow, cc = ch % kChunksPerRow;
        const bool valid = kr0 + r < d;  // rows past d read nothing and stage zeros
        const T* src = corpus_t + (size_t)(valid ? kr0 + r : 0) * n + col0 +
                       cc * (16 / (int)sizeof(T));
        cp_async16(stage + swz(r, cc, kRowBytes), src, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_stage(s);

  // queries: the staged rows zeroed, then the live rows' values (contiguous
  // in q) read with a batch of loads in flight a thread; cast to the corpus
  // dtype, or quantized (int8: a first pass takes each row's amax)
  for (int i = tid; i < R * qstride / 16; i += kThreads)
    reinterpret_cast<int4*>(qs)[i] = make_int4(0, 0, 0, 0);
  for (int r = tid; r < R; r += kThreads) q_scale[r] = 0.f;
  __syncthreads();
  const int nq = rows * d;
  const bool vec = d % 4 == 0;  // q is 16-byte aligned (the wrapper checks)
  constexpr int kPasses = std::is_same<T, int8_t>::value ? 2 : 1;
  for (int pass = 0; pass < kPasses; ++pass) {
    if (pass == 1) {  // q_scale held each row's amax bits (non-negative floats order as ints)
      for (int r = tid; r < rows; r += kThreads)
        q_scale[r] = __fdiv_rn(fmaxf(q_scale[r], 1e-8f), 127.f);
      __syncthreads();
    }
    for (int base = 0; base < nq; base += kThreads * 4 * kQBatch) {
      float v[kQBatch][4];
#pragma unroll
      for (int u = 0; u < kQBatch; ++u) {
        const int i = base + (u * kThreads + tid) * 4;
        const size_t at = (size_t)row0 * d + i;
        if (vec) {
          const float4 x = i < nq ? *reinterpret_cast<const float4*>(q + at)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          v[u][0] = x.x;
          v[u][1] = x.y;
          v[u][2] = x.z;
          v[u][3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e] = i + e < nq ? q[at + e] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kQBatch; ++u) {
        const int i = base + (u * kThreads + tid) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i + e >= nq) break;
          const int r = (i + e) / d, j = i + e - r * d;
          if constexpr (std::is_same<T, int8_t>::value) {
            if (pass == 0)
              atomicMax(reinterpret_cast<int*>(q_scale + r), __float_as_int(fabsf(v[u][e])));
            else
              reinterpret_cast<int8_t*>(qs + (size_t)r * qstride)[int8_kpos(j)] = (int8_t)(int)fminf(
                  fmaxf(rintf(__fdiv_rn(v[u][e], q_scale[r])), -127.f), 127.f);
          } else {
            reinterpret_cast<T*>(qs + (size_t)r * qstride)[j] = from_f32<T>(v[u][e]);
          }
        }
      }
    }
    __syncthreads();
  }
  clear_lists(sel, R, kp);
  for (int r = tid; r < R; r += kThreads) cnt[r] = 0;

  Acc acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;

  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_stage(s + kStages - 1);
    const int ks = s % ksteps;
    tile_product<T, NT>(ring + (s % kStages) * kStageBytes, qs, qstride, ks * KR, acc);
    if (ks != ksteps - 1) continue;

    // the tile's scores to shared memory (the next write of st follows at
    // least one more barrier of this loop), then a warp a query row
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cl = 32 * warp + 16 * mi + Tiling<T>::col(g, h);  // column in the tile
        const int col = (t0 + s / ksteps) * kTile + cl;
        const float msk = mask[col];
        const float csc = c_scale != nullptr ? c_scale[col] : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int e = 2 * h + par, row = nt * 8 + 2 * c + par;
            float v;
            if constexpr (std::is_same<T, int8_t>::value)
              v = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[mi][nt][e]), q_scale[row]),
                                      csc),
                            msk);
            else
              v = __fadd_rn(acc[mi][nt][e], msk);
            st[row * kScoreStride + cl] = v;
            acc[mi][nt][e] = 0;
          }
      }
    __syncthreads();
    const int col0 = (t0 + s / ksteps) * kTile;
    if (s < ksteps) {  // the block's first tile: its best kp are each row's list
      for (int r = warp; r < rows; r += kWarps)
        sort_into_list(row_sel(sel, r, kp), kp, st + r * kScoreStride, col0);
      continue;
    }
    // later tiles: kRowBatch rows' scores and thresholds read at once; a
    // row's passing scores go to its buffer in one step where they fit,
    // else through offer() (which merges a full buffer first)
    for (int r0 = warp; r0 < rows; r0 += kWarps * kRowBatch) {
      float v[kRowBatch][kTile / 32];
      bool pass[kRowBatch][kTile / 32];
#pragma unroll
      for (int bb = 0; bb < kRowBatch; ++bb) {
        const int r = min(r0 + kWarps * bb, rows - 1);
        const RowSel Rs = row_sel(sel, r, kp);
        const float ts = Rs.ls[k - 1];
        const int ti = Rs.li[k - 1];
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          v[bb][u] = st[r * kScoreStride + 32 * u + lane];
          pass[bb][u] = ranks_before(v[bb][u], col0 + 32 * u + lane, ts, ti);
        }
      }
#pragma unroll
      for (int bb = 0; bb < kRowBatch; ++bb) {
        const int r = r0 + kWarps * bb;
        if (r >= rows) break;
        unsigned mu[kTile / 32];
        int passed = 0;
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          mu[u] = __ballot_sync(kFull, pass[bb][u]);
          passed += __popc(mu[u]);
        }
        if (passed == 0) continue;
        const RowSel Rs = row_sel(sel, r, kp);
        int n_buf = cnt[r];
        if (n_buf + passed <= kp) {
#pragma unroll
          for (int u = 0; u < kTile / 32; ++u) {
            if (pass[bb][u]) {
              const int pos = n_buf + __popc(mu[u] & ((1u << lane) - 1u));
              Rs.bs[pos] = v[bb][u];
              Rs.bi[pos] = col0 + 32 * u + lane;
            }
            n_buf += __popc(mu[u]);
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int u = 0; u < kTile / 32; ++u)
            n_buf = offer(Rs, k, kp, n_buf, v[bb][u], col0 + 32 * u + lane, pass[bb][u]);
        }
        if (lane == 0) cnt[r] = n_buf;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const RowSel Rs = row_sel(sel, r, kp);
    if (cnt[r] > 0) merge_buffer(Rs, kp, cnt[r]);
    for (int t = lane; t < k; t += 32) {
      if (blocks == 1) {
        emit(Rs.ls[t], Rs.li[t], out_s + (size_t)(row0 + r) * k + t,
             out_i + (size_t)(row0 + r) * k + t);
      } else {
        const size_t o = ((size_t)(row0 + r) * blocks + p) * k + t;
        cand_s[o] = Rs.ls[t];
        cand_i[o] = Rs.li[t];
      }
    }
  }
  if (blocks == 1 || ticket == nullptr) return;

  // the last-block route: the candidates made visible, then a ticket a block
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const bool last = atomicAdd(ticket + blockIdx.y, 1u) == (unsigned)blocks - 1;
    if (last) atomicExch(ticket + blockIdx.y, 0u);  // every other block has taken its ticket
    cnt[0] = last;
  }
  __syncthreads();
  if (!cnt[0]) return;
  __threadfence();
  for (int r = 0; r < rows; ++r) {
    const size_t row = row0 + r;
    merge_candidates<kWarps>(cand_s + row * blocks * k, cand_i + row * blocks * k, blocks, k, kp,
                             sel, st, out_s + row * k, out_i + row * k);
  }
}

// The second-launch route: one block per query row.
__global__ void __launch_bounds__(kMergeThreads) rk_topk_merge_kernel(
    const float* __restrict__ cand_s, const int* __restrict__ cand_i, int blocks, int k, int kp,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int kMergeWarps = kMergeThreads / 32;
  extern __shared__ __align__(16) char sel[];  // a selection a warp
  __shared__ float cut[2 * kMergeWarps];
  const size_t row = blockIdx.x;
  merge_candidates<kMergeWarps>(cand_s + row * blocks * k, cand_i + row * blocks * k, blocks, k,
                                kp, sel, cut, out_s + row * k, out_i + row * k);
}

int kp_of(int k) {
  return k <= 32 ? 32 : (k <= 64 ? 64 : 128);
}

template <typename T, int NT>
int launch_score(const float* q, const void* corpus_t, const float* c_scale,
                 const float* mask, int b, int d, int n, int k, int blocks, float* cand_s,
                 int* cand_i, float* out_s, int* out_i, unsigned* ticket, cudaStream_t stream) {
  const int kp = kp_of(k);
  const size_t smem = score_smem<T>(8 * NT, d, kp);
  cudaError_t err = cudaFuncSetAttribute(rk_topk_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks, (b + 8 * NT - 1) / (8 * NT));
  rk_topk_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(corpus_t), c_scale, mask, b, d, n, k, kp, cand_s, cand_i, out_s,
      out_i, ticket);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1 || ticket != nullptr) return (int)err;
  rk_topk_merge_kernel<<<b, kMergeThreads, sel_bytes(kMergeThreads / 32, kp), stream>>>(
      cand_s, cand_i, blocks, k, kp, out_s, out_i);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const float* q, const void* corpus_t, const float* c_scale,
                const float* mask, int b, int d, int n, int k, int blocks, float* cand_s,
                int* cand_i, float* out_s, int* out_i, unsigned* ticket, cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch_score<T, 1>(q, corpus_t, c_scale, mask, b, d, n, k, blocks, cand_s,
                                cand_i, out_s, out_i, ticket, s);
    case 16:
      return launch_score<T, 2>(q, corpus_t, c_scale, mask, b, d, n, k, blocks, cand_s,
                                cand_i, out_s, out_i, ticket, s);
    case 32:
      return launch_score<T, 4>(q, corpus_t, c_scale, mask, b, d, n, k, blocks, cand_s,
                                cand_i, out_s, out_i, ticket, s);
    case 64:
      return launch_score<T, 8>(q, corpus_t, c_scale, mask, b, d, n, k, blocks, cand_s,
                                cand_i, out_s, out_i, ticket, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b, d) f32, cast to the corpus dtype in the kernel; corpus_t (d, n)
// f32 (dtype 0) or bf16 (1), n % 128 == 0; mask (n,) f32 additive; rows
// (8, 16, 32 or 64) query rows a block and blocks column blocks a row group
// (ops/topk.py::topk_plan); cand_s/cand_i hold b * blocks * k entries
// (unused when blocks == 1); out (b, k). ticket: null (the candidates
// merged by a second launch) or ceil(b / rows) zero words, which the
// launch leaves zero (the last block of each row group merges). 1 <= k <=
// 128, d <= 1024. Returns a cudaError_t.
int rk_topk(const float* q, const void* corpus_t, int dtype, const float* mask, int b, int d,
            int n, int k, int rows, int blocks, float* cand_s, int* cand_i, float* out_s,
            int* out_i, unsigned* ticket, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, q, corpus_t, nullptr, mask, b, d, n, k, blocks,
                                      cand_s, cand_i, out_s, out_i, ticket, s);
  return launch_rows<float>(rows, q, corpus_t, nullptr, mask, b, d, n, k, blocks, cand_s,
                            cand_i, out_s, out_i, ticket, s);
}

// q (b, d) f32, quantized per row in the kernel; corpus_t (d, n) int8 with
// c_scale (n,) f32; mask (n,) f32 additive; rows, blocks, workspace, out
// and ticket as rk_topk. 1 <= k <= 128, d <= 1024. Returns a cudaError_t.
int rk_topk_int8(const float* q, const int8_t* corpus_t, const float* c_scale,
                 const float* mask, int b, int d, int n, int k, int rows, int blocks,
                 float* cand_s, int* cand_i, float* out_s, int* out_i, unsigned* ticket,
                 void* stream) {
  return launch_rows<int8_t>(rows, q, corpus_t, c_scale, mask, b, d, n, k, blocks, cand_s,
                             cand_i, out_s, out_i, ticket, static_cast<cudaStream_t>(stream));
}

const char* rk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
