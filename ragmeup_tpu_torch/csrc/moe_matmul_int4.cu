// Grouped GEMM over packed-int4 stacked experts for Hopper (sm_90a):
//   out[i] = xp[i] @ dequant(w_p[texp[i / tm]] (k/2, n), gscale[...] (k/group, n))
// over rows sorted by expert and padded to tm-row tiles (ops/moe_matmul.py
// scatter_layout), w_p (E, k/2, n) int8, gscale (E, k/group, n) f32.
//
// Replaces the Pallas kernel ragmeup_tpu/ops/moe_matmul.py::_grouped_kernel4,
// the batched-decode route past the per-slot gate: each unique routed
// expert's packed bytes cross device memory once per tile of its rows. At
// Mixtral's batched decode (16 rows over about 7 experts, group 128) one
// layer's gate, up and down read about 7 x 93.6 MB of packed experts and
// scales: about 0.22 ms at 3.35 TB/s. The kernel is bound by those bytes, so
// its design is about keeping enough of them in flight, on every SM, all
// the time.
//
// Packing is per pack_tile rows: byte j of a tile holds row j in its low
// nibble and row j + pack_tile/2 in its high nibble. A k step takes P packed
// rows at p0 and feeds x's columns [klo, klo + P) with the low nibbles and
// [khi, khi + P) with the high ones: every packed byte is read once. A block
// reads its tile's expert and the used row count from device memory (no host
// sync); tiles from *used_rows on hold padding only and exit at once.
//
// bf16 activations (rk_moe_grouped_int4_mma_kernel), one block per (16-row
// tile, 128-column strip, k-slice):
// - Split-K. The wrapper cuts k into slices of whole packing tiles
//   (tiles_per_slice, chosen from the shapes and the card's SM count), so
//   the long down projection fills the card too; each slice writes its f32
//   partial to a workspace and rk_moe_grouped_int4_reduce_kernel adds them
//   in slice order (no atomics: the sum is the same on every run, the JAX
//   kernel's f32 parts added in k-block order). One slice writes bf16 at
//   once.
// - A cp.async ring of 16-byte copies holds each step's packed weights,
//   x's 16 rows of it and the scale rows it needs, one barrier a step. A
//   step is 128 packed rows (two stages: 18 KB of weights in flight a
//   block while the other multiplies) where the packing tile holds whole
//   such steps, else 32 (four stages). The long step pays the per-step
//   costs (addresses, the wait, the barrier) a quarter as often; on an
//   H100 it timed faster than 32 or 64 rows, and than 3 stages of 128,
//   which leave room for only 2 blocks an SM.
// - The nibbles go from shared memory straight into the B fragments of
//   mma.sync m16n8k16 (bf16, f32 accumulation); nothing is written back.
//   The mma's n index 4 g + j of lane group g takes column 4 g + j of the
//   warp's 32, so one 32-bit load gives a lane its bytes for all four of
//   its n-tiles; its two k rows are two packed rows, whose low nibbles feed
//   the klo chunk and whose high nibbles the khi chunk. Rows are padded to
//   144 bytes, so those loads are free of bank conflicts. x's fragments come
//   from shared memory by ldmatrix. Each route of the TPU kernel keeps its
//   arithmetic:
//   - group < pack_tile: each weight is f32(q) * f32(scale), rounded to bf16
//     (the plain version's arithmetic), into one f32 sum over the slice;
//   - group == pack_tile (output-scaled): the weights are the integers
//     themselves (exact in bf16), one f32 sum runs over a packing tile, and
//     at its end it is multiplied by the tile's scale and added to the
//     running f32 sum, in tile order.
// f32 activations (rk_moe_grouped_int4_f32_kernel) take f32 FMAs on 8-row
// tiles over all of k, since a tensor-core product would round them.

#include "common.cuh"

namespace {

constexpr int kBN = 128;      // columns per block
constexpr int kStepP = 32;    // packed rows per k step (64 rows of k)
constexpr int kStepK = 2 * kStepP;

// Where k step s of P packed rows lies: packed rows [p0, p0 + P) of packing
// tile t; x columns [klo, klo + P) take the low nibbles, [khi, khi + P) the
// high.
template <int P>
struct StepOf {
  int t, p0, klo, khi;
  __device__ StepOf(int s, int pack_tile) {
    const int half = pack_tile / 2;
    const int per_tile = half / P;
    t = s / per_tile;
    const int o = (s - t * per_tile) * P;
    p0 = t * half + o;
    klo = t * pack_tile + o;
    khi = klo + half;
  }
};
using Step = StepOf<kStepP>;

// ---------------------------------------------------------------------------
// bf16 activations: mma.sync over a cp.async ring, split-K
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;         // 4 warps x 32 columns
constexpr int kWLd = kBN + 16;        // bytes per shared packed row
constexpr int kDeepMP = 128;          // packed rows a step where the packing tile allows

// A step of kMP packed rows (2 kMP rows of k) and its ring: 4 stages of 32
// rows, or 2 of 128 (27 KB a stage at group 128; 4 blocks an SM still fit)
template <int kMP>
struct Ring {
  static constexpr int kMK = 2 * kMP;
  static constexpr int kStages = kMP == 32 ? 4 : 2;
  static constexpr int kXLd = kMK + 8;             // bf16 per shared x row
  static constexpr int kWBytes = kMP * kWLd;
  static constexpr int kXBytes = 16 * kXLd * 2;
  // scale rows a stage holds: none on the output-scaled route; one per
  // half (low, high) when a group covers a whole half of the step; else one
  // per 8 rows
  static __host__ __device__ int scale_rows(bool out_scaled, int group) {
    return out_scaled ? 0 : group % kMP == 0 ? 2 : kMK / 8;
  }
  static __host__ __device__ int stage_bytes(int nsc) {
    return kWBytes + kXBytes + nsc * kBN * 4;
  }
};

template <bool kOutScaled, int kMP>
__global__ void __launch_bounds__(kThreads, 4) rk_moe_grouped_int4_mma_kernel(
    const __nv_bfloat16* __restrict__ xp, const int8_t* __restrict__ w_p,
    const float* __restrict__ gs, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n, int pack_tile, int group,
    int tiles_per_slice, float* __restrict__ partial, __nv_bfloat16* __restrict__ out) {
  using R = Ring<kMP>;
  constexpr int kMK = R::kMK, kStages = R::kStages, kXLd = R::kXLd;
  constexpr int kWBytes = R::kWBytes, kXBytes = R::kXBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * 16;
  if (m0 >= *used_rows) return;
  const int n0 = blockIdx.x * kBN;
  const int slice = blockIdx.z;
  const size_t e = (size_t)texp[blockIdx.y];
  const int8_t* wbase = w_p + e * (size_t)(k / 2) * n + n0;
  const float* gbase = gs + e * (size_t)(k / group) * n + n0;
  const int per_tile = pack_tile / kMK;             // steps a packing tile
  const int t0 = slice * tiles_per_slice;           // the slice's first packing tile
  const int s0 = t0 * per_tile;
  const int steps = min(tiles_per_slice, k / pack_tile - t0) * per_tile;
  const int nsc = R::scale_rows(kOutScaled, group);
  const int sbytes = R::stage_bytes(nsc);
  const int tid = threadIdx.x;

  auto load = [&](int ls) {   // step s0 + ls into its ring slot, one commit group
    if (ls < steps) {
      unsigned char* st = smem + (ls % kStages) * sbytes;
      const StepOf<kMP> stp(s0 + ls, pack_tile);
      // packed weights: kMP rows x 128 bytes
#pragma unroll
      for (int i = tid; i < kMP * (kBN / 16); i += kThreads) {
        const int pr = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
        cp_async16(st + pr * kWLd + c, wbase + (size_t)(stp.p0 + pr) * n + c);
      }
      // x: 16 rows x (kMP columns from klo, kMP from khi)
#pragma unroll
      for (int i = tid; i < 16 * (kMK / 8); i += kThreads) {
        const int r = i / (kMK / 8), seg = i % (kMK / 8);
        const int col = seg < kMP / 8 ? stp.klo + seg * 8 : stp.khi + (seg - kMP / 8) * 8;
        cp_async16(st + kWBytes + (r * kXLd + seg * 8) * 2, xp + (size_t)(m0 + r) * k + col);
      }
      // scale rows: slot sl is half sl / (nsc / 2), 8-row run sl % (nsc / 2)
      float* sc = reinterpret_cast<float*>(st + kWBytes + kXBytes);
      for (int i = tid; i < nsc * (kBN / 4); i += kThreads) {
        const int sl = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
        const int half = sl / (nsc / 2), run = sl % (nsc / 2);
        const int row = ((half ? stp.khi : stp.klo) + 8 * run) / group;
        cp_async16(sc + sl * kBN + c, gbase + (size_t)row * n + c);
      }
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, cq = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;
  const int wcol = warp * 32 + 4 * gq;     // this lane's B columns, one a n-tile
  float acc[4][4], total[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = total[j][q] = 0.f;

#pragma unroll
  for (int ls = 0; ls < kStages - 1; ++ls) load(ls);
  for (int ls = 0; ls < steps; ++ls) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // step ls has landed; step ls - 1's slot is free
    load(ls + kStages - 1);
    const unsigned char* st = smem + (ls % kStages) * sbytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + kWBytes);
    const float* sc = reinterpret_cast<const float*>(st + kWBytes + kXBytes);
#pragma unroll
    for (int kc = 0; kc < kMP / 16; ++kc) {  // 16 packed rows: 16 deep of klo and of khi
      const unsigned char* wr = st + (16 * kc + 2 * cq) * kWLd + wcol;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kWLd);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wr + 8 * kWLd);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wr + 9 * kWLd);
      uint32_t a_lo[4], a_hi[4];
      const __nv_bfloat16* xa = xs + (mrow + 8 * (mat % 2)) * kXLd + 16 * kc + 8 * (mat / 2);
      ldmatrix_x4(a_lo, xa);
      ldmatrix_x4(a_hi, xa + kMP);
      float4 s_lo0, s_lo1, s_hi0, s_hi1;
      if (!kOutScaled) {   // b0 reads 8-row run 2 kc of its half, b1 run 2 kc + 1
        const int lo0 = nsc == 2 ? 0 : 2 * kc, hi0 = nsc == 2 ? 1 : nsc / 2 + 2 * kc;
        const int lo1 = nsc == 2 ? 0 : lo0 + 1, hi1 = nsc == 2 ? 1 : hi0 + 1;
        s_lo0 = *reinterpret_cast<const float4*>(sc + lo0 * kBN + wcol);
        s_lo1 = *reinterpret_cast<const float4*>(sc + lo1 * kBN + wcol);
        s_hi0 = *reinterpret_cast<const float4*>(sc + hi0 * kBN + wcol);
        s_hi1 = *reinterpret_cast<const float4*>(sc + hi1 * kBN + wcol);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of rows 2c, 2c + 1 (and 2c + 8, 2c + 9) at bytes 0 and 2
        const uint32_t sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12);
        const uint32_t t01 = __byte_perm(w0, w1, sel), t89 = __byte_perm(w8, w9, sel);
        uint32_t lo_b0 = nibbles_bf16x2(t01), lo_b1 = nibbles_bf16x2(t89);
        uint32_t hi_b0 = nibbles_bf16x2(t01 >> 4), hi_b1 = nibbles_bf16x2(t89 >> 4);
        if (!kOutScaled) {
          const float* l0 = &s_lo0.x;
          const float* l1 = &s_lo1.x;
          const float* h0 = &s_hi0.x;
          const float* h1 = &s_hi1.x;
          lo_b0 = scale_pair(lo_b0, l0[j]);
          lo_b1 = scale_pair(lo_b1, l1[j]);
          hi_b0 = scale_pair(hi_b0, h0[j]);
          hi_b1 = scale_pair(hi_b1, h1[j]);
        }
        mma_bf16(acc[j], a_lo, lo_b0, lo_b1);
        mma_bf16(acc[j], a_hi, hi_b0, hi_b1);
      }
    }
    if (kOutScaled && (ls + 1) % per_tile == 0) {
      // the packing tile's sum times its scale, added in tile order; this
      // lane's outputs are columns 8 cq .. 8 cq + 7 of the warp's 32
      const float* srow = gbase + (size_t)(t0 + ls / per_tile) * n + warp * 32 + 8 * cq;
      const float4 sa = __ldg(reinterpret_cast<const float4*>(srow));
      const float4 sb = __ldg(reinterpret_cast<const float4*>(srow + 4));
      const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          total[j][q] = __fadd_rn(total[j][q], __fmul_rn(acc[j][q], sv[(q & 1) * 4 + j]));
          acc[j][q] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[j][0 / 1] are row gq, columns 8 cq + j / 8 cq + 4 + j; [2 / 3] row gq + 8
  auto res = [&](int j, int q) { return kOutScaled ? total[j][q] : acc[j][q]; };
  const size_t col = (size_t)n0 + warp * 32 + 8 * cq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)m0 + gq + 8 * h;
    const float v[8] = {res(0, 2 * h), res(1, 2 * h), res(2, 2 * h), res(3, 2 * h),
                        res(0, 2 * h + 1), res(1, 2 * h + 1), res(2, 2 * h + 1),
                        res(3, 2 * h + 1)};
    if (partial == nullptr) {
      *reinterpret_cast<uint4*>(out + row * n + col) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    } else {
      float4* dst = reinterpret_cast<float4*>(
          partial + ((size_t)slice * gridDim.y * 16 + row) * n + col);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// out = partial[0] + partial[1] + ..., in slice order, rounded once to bf16;
// one thread per 8 columns, rows from *used_rows on untouched
__global__ void __launch_bounds__(256) rk_moe_grouped_int4_reduce_kernel(
    const float* __restrict__ partial, const int* __restrict__ used_rows, int mp, int n,
    int slices, __nv_bfloat16* __restrict__ out) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const size_t plane = (size_t)mp * n;
  if (i >= plane || (int)(i / n) >= *used_rows) return;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sl = 0; sl < slices; ++sl) {
    const float4* p = reinterpret_cast<const float4*>(partial + sl * plane + i);
    const float4 a = p[0], b = p[1];
    const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __fadd_rn(v[q], w[q]);
  }
  *reinterpret_cast<uint4*>(out + i) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// ---------------------------------------------------------------------------
// f32 activations: f32 FMAs, 8-row tiles, one column of the strip a thread
// ---------------------------------------------------------------------------

constexpr int kF32Threads = kBN;

// The 16 signed nibbles of one half (hi = false: low nibbles) of 16 packed
// bytes, each dequantized (kScaled: times its column's scale)
template <bool kScaled>
__device__ __forceinline__ void unpack16(const uint4& v, bool hi, const float* s,
                                         float (&f)[16]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint2 w2 = make_uint2(words[q], 0u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float iv = (float)(hi ? nib_hi(w2, c) : nib_lo(w2, c));
      f[4 * q + c] = kScaled ? __fmul_rn(iv, __ldg(s + 4 * q + c)) : iv;
    }
  }
}

template <bool kOutScaled>
__global__ void __launch_bounds__(kF32Threads) rk_moe_grouped_int4_f32_kernel(
    const float* __restrict__ xp, const int8_t* __restrict__ w_p,
    const float* __restrict__ gs, const int* __restrict__ texp,
    const int* __restrict__ used_rows, int k, int n, int pack_tile, int group,
    float* __restrict__ out) {
  constexpr int BM = 8;
  __shared__ float xs[BM][kStepK];
  __shared__ float ws[kStepK][kBN];
  const int m0 = blockIdx.y * BM;
  if (m0 >= *used_rows) return;
  const int n0 = blockIdx.x * kBN;
  const size_t e = (size_t)texp[blockIdx.y];
  const int8_t* wbase = w_p + e * (size_t)(k / 2) * n + n0;
  const float* gbase = gs + e * (size_t)(k / group) * n + n0;
  const int tid = threadIdx.x;
  const int steps = k / kStepK;
  const int per_tile = pack_tile / kStepK;
  float acc[BM], total[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = total[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const Step st(s, pack_tile);
    for (int i = tid; i < BM * kStepK; i += kF32Threads) {
      const int row = i / kStepK, j = i % kStepK;
      xs[row][j] = xp[(size_t)(m0 + row) * k + (j < kStepP ? st.klo + j : st.khi + j - kStepP)];
    }
    // 32 packed rows x 128 bytes: 256 16-byte loads, two a thread
    for (int i = tid; i < kStepP * (kBN / 16); i += kF32Threads) {
      const int pr = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wbase + (size_t)(st.p0 + pr) * n + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float f[16];
        const float* srow = gbase + (size_t)((h ? st.khi : st.klo) + pr) / group * n + c;
        unpack16<!kOutScaled>(v, h == 1, srow, f);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[h * kStepP + pr][c + q] = f[q];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStepK; ++kk) {
      const float wvv = ws[kk][tid];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = fmaf(xs[i][kk], wvv, acc[i]);
    }
    __syncthreads();
    if (kOutScaled && (s + 1) % per_tile == 0) {
      const float sc = __ldg(gbase + (size_t)(s / per_tile) * n + tid);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        total[i] = __fadd_rn(total[i], __fmul_rn(acc[i], sc));
        acc[i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BM; ++i)
    out[(size_t)(m0 + i) * n + n0 + tid] = kOutScaled ? total[i] : acc[i];
}

template <bool kOutScaled, int kMP>
int launch_mma(const __nv_bfloat16* x, const int8_t* w_p, const float* gscale,
               const int* texp, const int* used, int mp, int k, int n, int pack_tile,
               int group, int tiles_per_slice, float* partial, __nv_bfloat16* out,
               cudaStream_t s) {
  using R = Ring<kMP>;
  const int slices = (k / pack_tile + tiles_per_slice - 1) / tiles_per_slice;
  const int smem = R::kStages * R::stage_bytes(R::scale_rows(kOutScaled, group));
  cudaError_t err = cudaFuncSetAttribute(rk_moe_grouped_int4_mma_kernel<kOutScaled, kMP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rk_moe_grouped_int4_mma_kernel<kOutScaled, kMP>
      <<<dim3(n / kBN, mp / 16, slices), kThreads, smem, s>>>(
          x, w_p, gscale, texp, used, k, n, pack_tile, group, tiles_per_slice,
          slices > 1 ? partial : nullptr, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t threads = (size_t)mp * n / 8;
  rk_moe_grouped_int4_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      partial, used, mp, n, slices, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xp (mp, k) in dtype (0 = float32, 1 = bfloat16), rows padded to tm-row
// tiles (tm = 16 for bf16, 8 for float32); w_p (E, k/2, n) packed int8 per
// pack_tile rows; gscale (E, k/group, n) f32; texp (mp / tm,) int32 expert
// per tile; used (1,) int32, the rows the groups fill (tiles from there on
// are skipped, their rows left unwritten); out (mp, n) in x's dtype.
// bf16: k is cut into slices of tiles_per_slice packing tiles; with more
// than one slice, partial is an f32 workspace (slices, mp, n). float32 runs
// over all of k and reads neither. pack_tile % 64 == 0, k % pack_tile == 0,
// group divides pack_tile (bf16: group % 8 == 0), n % 128 == 0. Returns a
// cudaError_t.
int rk_moe_grouped_int4(const void* xp, const int8_t* w_p, const float* gscale,
                        const int* texp, const int* used, int mp, int k, int n,
                        int pack_tile, int group, int tiles_per_slice, int dtype,
                        float* partial, void* out, void* stream) {
  const int tm = dtype == 1 ? 16 : 8;
  if (pack_tile < kStepK || pack_tile % kStepK || k % pack_tile || group < 1 ||
      pack_tile % group || n % kBN || mp % tm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool out_scaled = group == pack_tile;
  if (dtype == 1) {
    const int slices = tiles_per_slice < 1 ? 0
                       : (k / pack_tile + tiles_per_slice - 1) / tiles_per_slice;
    if (slices < 1 || (!out_scaled && group % 8) || (slices > 1 && partial == nullptr))
      return (int)cudaErrorInvalidValue;
    const auto* x = static_cast<const __nv_bfloat16*>(xp);
    auto* o = static_cast<__nv_bfloat16*>(out);
    // the deep step where a packing tile holds whole steps of it
    const bool deep = pack_tile % (2 * kDeepMP) == 0;
    using Launch = int (*)(const __nv_bfloat16*, const int8_t*, const float*, const int*,
                           const int*, int, int, int, int, int, int, float*, __nv_bfloat16*,
                           cudaStream_t);
    const Launch launch =
        out_scaled ? (deep ? &launch_mma<true, kDeepMP> : &launch_mma<true, 32>)
                   : (deep ? &launch_mma<false, kDeepMP> : &launch_mma<false, 32>);
    return launch(x, w_p, gscale, texp, used, mp, k, n, pack_tile, group, tiles_per_slice,
                  partial, o, s);
  }
  const dim3 grid(n / kBN, mp / tm);
  const auto* x = static_cast<const float*>(xp);
  auto* o = static_cast<float*>(out);
  if (out_scaled)
    rk_moe_grouped_int4_f32_kernel<true><<<grid, kF32Threads, 0, s>>>(
        x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
  else
    rk_moe_grouped_int4_f32_kernel<false><<<grid, kF32Threads, 0, s>>>(
        x, w_p, gscale, texp, used, k, n, pack_tile, group, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
