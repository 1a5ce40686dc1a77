// The full-stack grouped expert GEMM for Hopper (sm_90a): bf16 activations
// against int8 experts with per-expert per-column scales (Mixtral's case),
// bf16 experts (with no scale, or with one) or f32 experts (a train step's
// master stacks), and the same product in the other orientation for dx.
//
// rk_moe_grouped_stack replaces ragmeup_tpu/ops/moe_matmul.py::_stack_kernel
// (the prefill route under moe_grouped="on"): rows sorted by expert and
// padded to 128-row tiles (ops/moe_matmul.py scatter_layout), tile i reading
// expert texp[i]; out[tile] = x[tile] @ w[texp[tile]].astype(bf16), f32
// products and sums, the scale on the sum, one rounding to bf16.
//
// What bounds it on this card: a Mixtral layer's prefill chunk (1,032 rows
// over 8 experts, gate/up 4096 x 14336 and down 14336 x 4096) must read
// 1.41 GB of int8 experts, 0.455 ms at 3.35 TB/s; the tensor work of its
// rows rounded up to 16-row fragments (1,104) is 389 GFLOP, 0.393 ms at 989
// TFLOP/s, close behind. The padded layout holds 1,536 rows, whose tensor
// work alone (0.547 ms) would pass the bytes bound.
//
// What the design does about it:
//   - The product runs transposed on wgmma, out^T = W^T x^T: a block owns
//     one 128-row tile (one expert) x a 128-column strip over all of k, and
//     each of its two warpgroups 64 of the columns as the M side of
//     m64nNk16 wgmmas, whose f32 sums stay in registers in k order (no
//     split-K: a greedy decode repeats bit for bit). The weights are the
//     register operand: each warp turns its 16 columns of the int8 stage
//     into A fragments with ldmatrix.trans (a lane receives two k rows x
//     two adjacent columns a register) and three integer instructions and
//     one bf16 subtraction a k pair of a column (s8x2_bf16x2; exact, off the
//     conversion unit), so each weight is converted once a block, with
//     column 2g of a 16-column group as fragment row g and 2g + 1 as row g +
//     8. x is the shared-memory operand, read by the tensor cores through a
//     128-byte-swizzled descriptor.
//   - A cp.async ring of 64-deep stages (4 with int8 experts, 3 with bf16)
//     holds x's bf16 tile (swizzled) and the raw weight tile (rows padded
//     16 bytes, so ldmatrix phases hit 8 distinct bank groups); int8
//     crosses L2 -> SM and sits in shared memory at one byte a weight.
//     Each stage's four wgmmas are drained before the next stage's
//     fragments are built. At 2 blocks an SM (128 registers a thread)
//     ptxas runs them one after another (its C7512 note); the forms that
//     kept them in flight (1 block an SM, blocks of half a tile, a stage
//     left running) measured slower on the H100.
//   - Padding is skipped: rows[i] is tile i's count of real rows. The
//     wgmmas' N is that count rounded up to 32 (32, 64, 96 or 128), x's
//     padding rows are not read (cp.async zero-fill), and no padding row
//     is stored.
//   - A persistent grid (2 blocks an SM x SMs) walks the (tile, strip)
//     pairs below *used on the device, strips fastest: the blocks that run
//     together read whole weight rows of one or two experts (a Mixtral
//     chunk's 264 blocks span 2-3 tiles), and an expert's second tile reads
//     its strips while the first does, so from L2 (the TPU kernel's
//     once-per-(kb, nb) property). Tiles fastest measured slower on the
//     H100.
//   - The epilogue scales each column in f32, rounds once to bf16, stages
//     the tile in shared memory and writes its real rows in 16-byte stores.
//
// f32 experts (a train step's master stacks): the same product with
// each f32 weight pair rounded to bf16 by one cvt.rn.bf16x2.f32 as its A
// fragment is built (the rounding of #11's grouped-rows kernel<float>, so
// the function is unchanged). A Mixtral projection at 2,048 rows must read
// 1.88 GB of f32 stacks, 0.56 ms at 3.35 TB/s. The stage keeps the f32 tile as it lands
// (cp.async, rows padded so the fragments' 8-byte reads hit distinct
// banks): 3 stages of 49-52 KB, one block an SM. Converting as the tile
// lands would halve the stage but put the loads through registers; every
// weight byte crosses L2 -> SM either way, and that traffic (the weights'
// 4 bytes against x's tile of 128 rows) is what bounds a block. The blocks
// walk an expert's tiles fastest within each strip, so the 2-3 tiles of a
// 256-row group read a weight strip together, from L2 after the first.
//
// rk_moe_grouped_stack_t is the other orientation, the grouped GEMM's dx
// (ops/moe_matmul.py GroupedKernelPath; JAX: moe_grouped_matmul(dy,
// swapaxes(w, 1, 2)) in _grouped_kp_bwd): out = x w[e]^T with w (E, n, k)
// as it lies, so no transposed copy of the stacks. out^T = w[e] x^T: each
// stored row of w[e] is an output column with the reduction contiguous,
// already the K-major A operand, read by ldmatrix without .trans (bf16) or
// by 8-byte loads (f32); a stage holds 128 such rows x 64 of the reduction.

#include "common.cuh"

namespace {

constexpr int kStackTM = 128;        // rows a tile (scatter_layout's tm): wgmma's largest N
constexpr int kStackBN = 128;        // columns a strip: a warpgroup each 64
constexpr int kStackBK = 64;         // k a stage: one 128-byte swizzled x row
constexpr int kStackStagesS8 = 4;    // ring depth, int8 experts
constexpr int kStackStagesWide = 3;  // ring depth, bf16 and f32 experts
constexpr int kStackThreads = 2 * kStackBN;  // 128 threads a warpgroup

// W the experts' type; kT: w[e] stored (n, k), out = x w[e]^T (dx);
// otherwise stored (k, n), out = x w[e].
template <typename W, bool kT>
struct StackTile {
  static constexpr bool kF32 = sizeof(W) == 4;
  static constexpr int kStages = sizeof(W) == 1 ? kStackStagesS8 : kStackStagesWide;
  // the persistent grid's blocks an SM: f32 stages take 147-157 KB
  static constexpr int kBlocksPerSM = kF32 ? 1 : 2;
  static constexpr int kXBytes = kStackTM * kStackBK * 2;
  // the staged weight tile: k rows x the strip's columns, or (kT) the
  // strip's output rows x 64 of k; rows padded so that ldmatrix phases
  // and the f32 fragments' 8-byte reads hit distinct banks
  static constexpr int kWRowsStage = kT ? kStackBN : kStackBK;
  static constexpr int kWRowBytes = (kT ? kStackBK : kStackBN) * (int)sizeof(W);
  static constexpr int kWLd = kWRowBytes + (kT && kF32 ? 32 : 16);
  static constexpr int kStageBytes = kXBytes + kWRowsStage * kWLd;
  static constexpr int kOLd = kStackBN + 8;                   // bf16 a staged output row
  static constexpr int kSmem = (kStages * kStageBytes > kStackTM * kOLd * 2
                                    ? kStages * kStageBytes : kStackTM * kOLd * 2) + 1024;
  // fragment row g holds column 2g and row g + 8 column 2g + 1 (int8, and
  // f32 as stored (k, n): two adjacent columns a read), else g and g + 8
  static constexpr bool kPairCols = !kT && sizeof(W) != 2;
  // f32: the blocks walk an expert's tiles fastest within a strip
  static constexpr bool kExpertOrder = kF32;
  static_assert(kStackBK * 2 == 128 && kStageBytes % 1024 == 0, "128-byte swizzle atoms");
  static_assert(kStages >= 2, "the ring refills a stage no wgmma reads");
  static_assert(!(kT && sizeof(W) == 1), "dx takes float experts");
};

// One register of ldmatrix.trans over an int8 tile: bytes 0, 1 are k row 2c
// at columns 2g, 2g + 1, bytes 2, 3 k row 2c + 1 at the same columns. Out:
// the k pair of column 2g (even) and of column 2g + 1 (odd).
__device__ __forceinline__ void s8x4_bf16x2(uint32_t r, uint32_t& even, uint32_t& odd) {
  even = s8x2_bf16x2(r);
  odd = s8x2_bf16x2(r >> 8);
}

// d (64 x N, f32; lane 4g + c of warp w holds rows 16w + g, + 8 x columns
// 8j + 2c, + 1 as d[4j .. 4j + 3]) += a (64 x 16 bf16, mma.sync's A layout
// a warp) * b (16 x N bf16, K-major at desc)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[kStackTM / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }

}

// A fragments of a stage's four 16-deep slices for this warp's 16 columns
// (col0 ..), rows as StackTile::kPairCols says. f32 weights round to bf16
// pair by pair (cvt.rn.bf16x2.f32).
template <typename W, bool kT>
__device__ __forceinline__ void stack_a_frags(uint32_t (&a)[4][4], const unsigned char* ws,
                                              int lane, int col0) {
  using T = StackTile<W, kT>;
  const int g = lane / 4;
  const int c = lane % 4;
  if constexpr (kT && sizeof(W) == 2) {
    // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
    // (rows 8-15, k 8-15) of slice j: mma's A as it lies
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldmatrix_x4(a[j], ws + (col0 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kWLd +
                            (j * 16 + (lane >> 4) * 8) * 2);
  } else if constexpr (kT) {
    // f32 rows of 64 k: fragment (row, k 2c, 2c + 1) is one 8-byte read
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(
            ws + (col0 + g + (i & 1) * 8) * T::kWLd + (j * 16 + 2 * c + (i >> 1) * 8) * 4);
        a[j][i] = pack_bf16x2(v.x, v.y);
      }
  } else if constexpr (sizeof(W) == 4) {
    // f32 k rows: one 8-byte read holds columns 2g, 2g + 1 of a k row
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* r = ws + (j * 16 + 2 * c + h * 8) * T::kWLd + (col0 + 2 * g) * 4;
        const float2 lo = *reinterpret_cast<const float2*>(r);
        const float2 hi = *reinterpret_cast<const float2*>(r + T::kWLd);
        a[j][2 * h] = pack_bf16x2(lo.x, hi.x);
        a[j][2 * h + 1] = pack_bf16x2(lo.y, hi.y);
      }
  } else if constexpr (sizeof(W) == 1) {
    // matrices: k rows 0-7, 8-15, 16-23, 24-31 of two slices
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, ws + (h * 32 + (lane >> 3) * 8 + (lane & 7)) * T::kWLd + col0);
      s8x4_bf16x2(r[0], a[2 * h][0], a[2 * h][1]);
      s8x4_bf16x2(r[1], a[2 * h][2], a[2 * h][3]);
      s8x4_bf16x2(r[2], a[2 * h + 1][0], a[2 * h + 1][1]);
      s8x4_bf16x2(r[3], a[2 * h + 1][2], a[2 * h + 1][3]);
    }
  } else {
    // matrices: (k 0-7, columns 0-7), (k 0-7, 8-15), (k 8-15, 0-7), (k 8-15, 8-15)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldmatrix_x4_trans(a[j], ws + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * T::kWLd +
                                  (col0 + ((lane >> 3) & 1) * 8) * 2);
  }
}

// This thread's share of each stage's copies, its addresses worked out
// once an item: x rows xrow + q * kXRows (the rest of the tile's rows
// zero-filled past `real`), weight rows wrow + q * kWRows.
template <typename W, bool kT>
struct StackCopies {
  using T = StackTile<W, kT>;
  static constexpr int kWRowChunks = T::kWRowBytes / 16;
  static constexpr int kXRows = kStackThreads / 8;              // 8 chunks an x row
  static constexpr int kWRows = kStackThreads / kWRowChunks;
  static_assert(kXRows % 8 == 0 && kStackTM % kXRows == 0 && T::kWRowsStage % kWRows == 0,
                "whole rows a pass, the swizzle phase fixed");
  const __nv_bfloat16* x;   // its first x chunk at k 0
  const unsigned char* w;   // its first weight chunk at k 0
  size_t wld;               // bytes between stored weight rows
  size_t wstep;             // bytes a k-step moves the weight tile
  int xdst, wdst;           // their offsets in a stage
  int xrow;

  // wbase: the item's expert at its strip (column n0, or row n0 if kT)
  __device__ __forceinline__ StackCopies(const __nv_bfloat16* xp, const W* wbase, int m0,
                                         int k, int n, int tid) {
    xrow = tid / 8;
    const int xc = tid % 8;
    x = xp + (size_t)(m0 + xrow) * k + xc * 8;
    xdst = xrow * 128 + ((xc ^ (xrow & 7)) << 4);               // 128-byte swizzle
    wld = (size_t)(kT ? k : n) * sizeof(W);
    wstep = kT ? kStackBK * sizeof(W) : kStackBK * wld;
    const int wr = tid / kWRowChunks;
    const int wc = tid % kWRowChunks;
    w = reinterpret_cast<const unsigned char*>(wbase) + wr * wld + wc * 16;
    wdst = T::kXBytes + wr * T::kWLd + wc * 16;
  }

  // k-step `step` into its slot of the ring
  __device__ __forceinline__ void load(unsigned char* smem, int step, int real, int k) const {
    unsigned char* st = smem + (step % T::kStages) * T::kStageBytes;
    const int k0 = step * kStackBK;
#pragma unroll
    for (int q = 0; q < kStackTM / kXRows; ++q)
      cp_async16(st + xdst + q * kXRows * 128, x + (size_t)q * kXRows * k + k0,
                 xrow + q * kXRows < real);
    const unsigned char* wk = w + step * wstep;
#pragma unroll
    for (int q = 0; q < T::kWRowsStage / kWRows; ++q)
      cp_async16(st + wdst + q * kWRows * T::kWLd, wk + q * kWRows * wld);
  }
};

// The sums of one (tile, strip) over all of k, the wgmmas' N the tile's live
// rows (compiled once per N, so no branch sits between them).
template <typename W, bool kT, int N>
__device__ __forceinline__ void stack_mainloop(float (&acc)[kStackTM / 2], unsigned char* smem,
                                               const StackCopies<W, kT>& copies, int real,
                                               int k, int lane, int col0) {
  using T = StackTile<W, kT>;
  constexpr int kAhead = T::kStages - 1;   // stages loading ahead
  const int nk = k / kStackBK;
  uint32_t a[4][4];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) copies.load(smem, s, real, k);
    cp_async_commit();
  }
  for (int step = 0; step < nk; ++step) {
    cp_async_wait<kAhead - 1>();
    wgmma_wait<0>();
    fence_proxy_async();
    // every warp's copies of this stage have landed, and no wgmma still
    // reads the stage refilled next (the last ones read the previous stage)
    __syncthreads();
    if (step + kAhead < nk) copies.load(smem, step + kAhead, real, k);
    cp_async_commit();
    const unsigned char* st = smem + (step % T::kStages) * T::kStageBytes;
    stack_a_frags<W, kT>(a, st + T::kXBytes, lane, col0);
    fence_frags(a);
    fence_acc(acc);
    wgmma_fence();
    const uint32_t xs = smem_addr(st);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<N>(acc, a[j], sw128_desc(xs + j * 32));
    wgmma_commit();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

template <typename W, bool kT>
__global__ void __launch_bounds__(kStackThreads, (StackTile<W, kT>::kBlocksPerSM))
rk_moe_stack_wgmma_kernel(const __nv_bfloat16* __restrict__ xp, const W* __restrict__ w,
                          const float* __restrict__ scale, const int* __restrict__ texp,
                          const int* __restrict__ rows, const int* __restrict__ used,
                          int k, int n, __nv_bfloat16* __restrict__ out) {
  using T = StackTile<W, kT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int col0 = (warp / 4) * 64 + (warp % 4) * 16;   // warpgroup's 64, warp's 16
  const int strips = n / kStackBN;
  const int tiles = (*used + kStackTM - 1) / kStackTM;
  const int items = tiles * strips;                      // (tile, strip)s

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int tile, strip;
    if constexpr (T::kExpertOrder) {
      // the expert's tiles t0 .. t1 - 1 hold items t0 * strips ..
      // t1 * strips - 1, tiles fastest
      const int t = item / strips;
      const int ex = __ldg(texp + t);
      int t0 = t, t1 = t + 1;
      while (t0 > 0 && __ldg(texp + t0 - 1) == ex) --t0;
      while (t1 < tiles && __ldg(texp + t1) == ex) ++t1;
      const int rel = item - t0 * strips;
      tile = t0 + rel % (t1 - t0);
      strip = rel / (t1 - t0);
    } else {
      tile = item / strips;                  // strips fastest
      strip = item % strips;
    }
    const int m0 = tile * kStackTM;
    const int n0 = strip * kStackBN;
    const int real = rows[tile];             // 1-128 below *used
    const size_t e = (size_t)texp[tile];
    const W* wbase = w + e * (size_t)k * n + (kT ? (size_t)n0 * k : (size_t)n0);
    const int nlive = min(kStackTM, (real + 31) / 32 * 32);   // x rows the wgmmas read

    const StackCopies<W, kT> copies(xp, wbase, m0, k, n, tid);
    float acc[kStackTM / 2];
#pragma unroll
    for (int i = 0; i < kStackTM / 2; ++i) acc[i] = 0.f;
    if (nlive == 128)
      stack_mainloop<W, kT, 128>(acc, smem, copies, real, k, lane, col0);
    else if (nlive == 96)
      stack_mainloop<W, kT, 96>(acc, smem, copies, real, k, lane, col0);
    else if (nlive == 64)
      stack_mainloop<W, kT, 64>(acc, smem, copies, real, k, lane, col0);
    else
      stack_mainloop<W, kT, 32>(acc, smem, copies, real, k, lane, col0);
    cp_async_wait<0>();
    __syncthreads();

    // epilogue: acc[4j + q] is row 8j + 2c + q % 2 of the tile, column col0
    // + (pair columns: 2g + q / 2; else g + 8 (q / 2)) of the strip
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + (T::kPairCols ? 2 * g + h : g + 8 * h);
      sc[h] = scale != nullptr ? __ldg(scale + e * n + n0 + col) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kStackTM / 8; ++j) {
      if (8 * j < nlive) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1;
          const int col = col0 + (T::kPairCols ? 2 * g + h : g + 8 * h);
          const float v = scale != nullptr ? acc[4 * j + q] * sc[h] : acc[4 * j + q];
          os[(8 * j + 2 * c + (q & 1)) * T::kOLd + col] = __float2bfloat16_rn(v);
        }
      }
    }
    __syncthreads();
    constexpr int kRowChunks = kStackBN / 8;
#pragma unroll
    for (int q = 0; q < kStackTM * kRowChunks / kStackThreads; ++q) {
      const int i = tid + q * kStackThreads;
      const int r = i / kRowChunks;
      const int cc = i % kRowChunks;
      if (r < real)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n + n0 + cc * 8) =
            *reinterpret_cast<const uint4*>(os + r * T::kOLd + cc * 8);
    }
    __syncthreads();  // the next item's copies overwrite the staged tile
  }
}

template <typename W, bool kT>
int launch_stack(const void* xp, const void* w, const float* scale, const int* texp,
                 const int* rows, const int* used, int k, int n, int grid, void* out,
                 cudaStream_t s) {
  using T = StackTile<W, kT>;
  cudaError_t err = cudaFuncSetAttribute(rk_moe_stack_wgmma_kernel<W, kT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmem);
  if (err != cudaSuccess) return (int)err;
  rk_moe_stack_wgmma_kernel<W, kT><<<grid, kStackThreads, T::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const W*>(w), scale, texp, rows,
      used, k, n, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xp (mp, k) bf16, rows sorted by expert and padded to 128-row tiles; w (E,
// k, n) int8 (wtype 2), bf16 (wtype 1) or f32 (wtype 0); scale (E, n) f32 or
// null; texp (mp / 128,) int32, tile i's expert; rows (mp / 128,) int32,
// tile i's real rows (0-128; its other rows are padding); used (1,) int32,
// the rows the groups fill. out (mp, n) bf16: only the real rows of tiles
// below *used are written; padding rows and later tiles are left as they
// were and must not be read. The wgmmas read x's rows up to the real ones
// rounded up to 32 and no further. grid: the persistent blocks (2 an SM
// times the SMs; f32 experts 1 an SM), which walk the (tile, strip) pairs
// strips fastest (f32: an expert's tiles fastest within a strip). k % 64
// == 0, n % 128 == 0. Returns a cudaError_t.
int rk_moe_grouped_stack(const void* xp, const void* w, const float* scale,
                         const int* texp, const int* rows, const int* used, int k, int n,
                         int wtype, int grid, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kStackBK || n % kStackBN || grid < 1) return (int)cudaErrorInvalidValue;
  if (wtype == 2)
    return launch_stack<int8_t, false>(xp, w, scale, texp, rows, used, k, n, grid, out, s);
  if (wtype == 1)
    return launch_stack<__nv_bfloat16, false>(xp, w, scale, texp, rows, used, k, n, grid,
                                              out, s);
  if (wtype == 0)
    return launch_stack<float, false>(xp, w, scale, texp, rows, used, k, n, grid, out, s);
  return (int)cudaErrorInvalidValue;
}

// The dx orientation: out (mp, n) = xp (mp, k) w[e]^T per tile, w (E, n, k)
// bf16 (wtype 1) or f32 (wtype 0) as it lies, no scale; the other
// arguments as rk_moe_grouped_stack's.
int rk_moe_grouped_stack_t(const void* xp, const void* w, const int* texp, const int* rows,
                           const int* used, int k, int n, int wtype, int grid, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kStackBK || n % kStackBN || grid < 1) return (int)cudaErrorInvalidValue;
  if (wtype == 1)
    return launch_stack<__nv_bfloat16, true>(xp, w, nullptr, texp, rows, used, k, n, grid,
                                             out, s);
  if (wtype == 0)
    return launch_stack<float, true>(xp, w, nullptr, texp, rows, used, k, n, grid, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
