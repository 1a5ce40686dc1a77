"""The int8 expert matmuls #10 and #11 timed on one card, stream-only
copies of the load loops they had before their redesign, and the grouped
GEMM's training route over f32 master stacks.

    python3 ragmeup_tpu_torch/tools/moe_times.py [--tree DIR] [--stream] [--train]

Imports ``ragmeup_tpu_torch`` from the checkout at DIR (by default the one
that holds this file), draws int8 experts with per-column scales (seed 0)
on the card, and prints the card's name and power limit, then one JSON
line, each time from a CUDA graph's replay (the wrappers' host cost
exceeds the kernels' device time):

- ``gather_graph_ms``: ``moe_gather_matmul`` (#10) over one decode layer's
  gate, up and down: Mixtral-8x7B (E 8, 4096 x 14336 and 14336 x 4096) at 2
  slots (experts 5 and 2), and Qwen3-30B-A3B (E 128, 2048 x 768 and 768 x
  2048) at 8 slots;
- ``grouped_graph_ms``: ``moe_grouped_matmul`` (#11) on the dedup route
  over one Mixtral layer at 16 rows, groups [3, 2, 0, 4, 1, 2, 3, 1], int8
  and bf16 experts (``function``), and the kernel alone (``kernel``): the
  padded layout's kernel where the tree has one (``grouped_padded``), the
  kernel on the sorted rows where the tree has that (``grouped_rows``);
- ``grouped_mm_bf16_ms``: ``torch._grouped_mm`` on the same bf16 stacks,
  which computes the same function as #11 over bf16 experts (a yardstick);
- with ``--stream``: ``stream_graph_ms``, copies of the load loops of #10's
  and #11's first CUDA kernels (``rk_moe_gather_partial_kernel`` and
  ``rk_moe_grouped_wmma_kernel``) that load the same bytes in the same
  order and only XOR them together: #10's 128-thread
  blocks, one 4-byte load a row and lane over its k slice; #11's 256-thread
  blocks, each 64-deep step's x tile and 64 x 128 weight tile as 16-byte
  loads, one block per (16-row tile, 128-column strip). The source is
  compiled with nvcc into ``build/`` beside the kernel library;
- with ``--train`` (``train_graph_ms``, and only that): the grouped GEMM's
  training route at one Mixtral layer, 2,048 bf16 rows (groups drawn as
  chip_smoke.py's phase 9 draws them, seed 44) over 8 f32 stacks, up
  4096 -> 14336 and down 14336 -> 4096: ``forward`` (``moe_grouped_matmul``
  with no gradient), ``dx`` and ``dw`` as the tree's
  ``GroupedKernelPath.backward`` computes them (a tree without
  ``stacks_transposed`` makes a contiguous transposed copy of the stacks in
  the call, as its backward did; dw is the tree's ``grouped_weight_grad``),
  ``backward`` (dx and dw), ``fwd_bwd_eager`` (forward and backward through
  autograd, eager: CUDA events around the calls); where the tree has the
  stack kernel's dx orientation, ``forward_kernel_one_call`` and
  ``dx_kernel_one_call`` (the stack kernel over all 2,048 rows' padded
  layout in one call, where the route cuts them into two chunks); and the
  yardsticks ``cast`` (the stacks cast to bf16 as they lie),
  ``cast_grouped_mm`` (one copy casts the stacks to bf16 in the (n, k)
  layout ``torch._grouped_mm`` takes, then that call: the same function
  over the rounded stacks) and ``grouped_mm_precast`` (the call alone).

Medians of five rounds after warm-up rounds until two agree within 5 %. To
compare a parent commit on one card, unpack ``git archive <parent>`` into
``build/parent`` and run the tool in one command in the order parent,
change, change, parent (``--tree build/parent`` for the parent's runs).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

MIXTRAL = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
QWEN3 = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
GROUPS = [3, 2, 0, 4, 1, 2, 3, 1]
DEDUP = dict(tm=16, tile_k=2048, tile_n=1024, no_stack=True)

STREAM_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// #10's old load loop: grid (n / 512, k / k_slice, slots), 128 threads,
// 4 adjacent columns a lane, one char4 load a row
__global__ void __launch_bounds__(128) gather_stream(const int8_t* __restrict__ w,
    const int* __restrict__ ids, int k, int n, int k_slice, int* __restrict__ sink) {
  const int s = blockIdx.z;
  const int k0 = blockIdx.y * k_slice;
  const int col = (blockIdx.x * 128 + threadIdx.x) * 4;
  if (col >= n) return;
  const int8_t* wp = w + ((size_t)ids[s] * k + k0) * n + col;
  int acc = 0;
#pragma unroll 8
  for (int j = 0; j < k_slice; ++j) acc ^= __ldg(reinterpret_cast<const int*>(wp + (size_t)j * n));
  if (acc == 0x7fffffff) sink[threadIdx.x] = acc;
}
// #11's old load loop: grid (n / 128, mp / 16), 256 threads; each 64-deep
// step loads the tile's 16 x 64 bf16 rows and the 64 x 128 int8 weights
__global__ void __launch_bounds__(256) grouped_stream(const uint4* __restrict__ xp,
    const int8_t* __restrict__ w, const int* __restrict__ texp, const int* __restrict__ used,
    int k, int n, int* __restrict__ sink) {
  const int m0 = blockIdx.y * 16;
  if (m0 >= *used) return;
  const int8_t* wb = w + (size_t)texp[blockIdx.y] * k * n + blockIdx.x * 128;
  const int t = threadIdx.x;
  uint32_t acc = 0;
  for (int k0 = 0; k0 < k; k0 += 64) {
    if (t < 128) {
      const uint4 v = xp[((size_t)(m0 + t / 8) * k + k0) / 8 + t % 8];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = t + 256 * q;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wb + (size_t)(k0 + i / 8) * n
                                                           + (i % 8) * 16));
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x7fffffffu) sink[t] = (int)acc;
}
extern "C" int gather_stream_launch(const void* w, const int* ids, int slots, int k, int n,
                                    int k_slice, int* sink, void* stream) {
  gather_stream<<<dim3((n + 511) / 512, k / k_slice, slots), 128, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, ids, k, n, k_slice, sink);
  return (int)cudaGetLastError();
}
extern "C" int grouped_stream_launch(const void* xp, const void* w, const int* texp,
                                     const int* used, int mp, int k, int n, int* sink,
                                     void* stream) {
  grouped_stream<<<dim3(n / 128, mp / 16), 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)xp, (const int8_t*)w, texp, used, k, n, sink);
  return (int)cudaGetLastError();
}
"""


def graph_ms(fn, reps: int = 20, rounds: int = 5, warm_rounds: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, the replay timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()

    def one_round() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    last = one_round()
    for _ in range(warm_rounds - 1):
        now = one_round()
        if abs(now - last) <= 0.05 * last:
            break
        last = now
    return statistics.median(one_round() for _ in range(rounds))


def experts(gen, e: int, shapes: dict, kind: str = "int8") -> dict:
    import torch
    out = {}
    for name, (k, n) in shapes.items():
        if kind == "int8":
            out[name] = (torch.randint(-127, 128, (e, k, n), generator=gen, device="cuda",
                                       dtype=torch.int8),
                         torch.rand(e, n, generator=gen, device="cuda") * 2e-4 + 1e-4)
        else:
            out[name] = ((torch.randn(e, k, n, generator=gen, device="cuda") * 0.02)
                         .to(torch.bfloat16), None)
    return out


def stream_library(tree: str) -> ctypes.CDLL:
    """The stream-only copies, built with nvcc into the tree's build/."""
    from ragmeup_tpu_torch import kernels
    out_dir = os.path.join(tree, "build", "moe_stream")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "moe_stream.cu")
    so = os.path.join(out_dir, "libmoe_stream.so")
    with open(src, "w") as f:
        f.write(STREAM_SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gather_stream_launch.argtypes = [vp, vp, i32, i32, i32, i32, vp, vp]
    lib.grouped_stream_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp, vp]
    return lib


def stream_times(tree, mm, gen, mixtral, qwen, xs16) -> dict:
    """The old load loops alone, at the shapes and k slices the old
    kernels ran (two blocks an SM, k slices of 256 down to 16 rows)."""
    import torch
    from ragmeup_tpu_torch import kernels
    lib = stream_library(tree)

    def stream():  # the current stream at the call: a graph captures on its own
        return torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(256, dtype=torch.int32, device="cuda")
    target = 2 * kernels.sm_count(0)

    def k_slice(k, n, slots):
        blocks = -(-n // 512) * slots
        divisors = [s for s in (256, 128, 64, 32, 16) if k % s == 0]
        return next((s for s in divisors if blocks * (k // s) >= target), divisors[-1])

    def gather(weights, ids):
        ids32 = ids.to(torch.int32)
        return lambda: [lib.gather_stream_launch(w.data_ptr(), ids32.data_ptr(), len(ids),
                                                 w.shape[1], w.shape[2],
                                                 k_slice(w.shape[1], w.shape[2], len(ids)),
                                                 sink.data_ptr(), stream())
                        for w, _ in weights.values()]
    out = {"gather_mixtral_s2": graph_ms(gather(mixtral, torch.tensor([5, 2], device="cuda"))),
           "gather_qwen3_s8": graph_ms(gather(qwen, torch.randperm(
               128, generator=gen, device="cuda")[:8]))}
    gsz = torch.tensor(GROUPS, device="cuda")
    padded = {k: mm.scatter_layout(x, gsz, 16, 8) for k, x in xs16.items()}
    texp32 = {k: p[2].to(torch.int32) for k, p in padded.items()}
    used32 = {k: p[3].to(torch.int32) for k, p in padded.items()}

    def grouped():
        for w, _ in mixtral.values():
            xp = padded[w.shape[1]][0]
            lib.grouped_stream_launch(xp.data_ptr(), w.data_ptr(), texp32[w.shape[1]].data_ptr(),
                                      used32[w.shape[1]].data_ptr(), xp.shape[0], w.shape[1],
                                      w.shape[2], sink.data_ptr(), stream())
    out["grouped_mixtral_16_rows"] = graph_ms(grouped)
    return out


def eager_ms(fn, reps: int = 3, rounds: int = 5) -> float:
    """Mean time of ``reps`` eager calls (CUDA events), the median of
    ``rounds`` after one warm-up round."""
    import torch

    def one_round() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    one_round()
    return statistics.median(one_round() for _ in range(rounds))


def train_times(mm) -> dict:
    """The --train readings (see the module's docstring)."""
    import torch
    e, m = 8, 2048
    gen = torch.Generator(device="cuda").manual_seed(44)
    ids = torch.randint(0, e, (m,), generator=gen, device="cuda")
    gsz = torch.bincount(ids, minlength=e)
    offs = torch.cumsum(gsz, 0).to(torch.int32)
    out = {"groups": gsz.tolist()}
    for proj, (k, n) in (("up", (4096, 14336)), ("down", (14336, 4096))):
        x = (torch.randn(m, k, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        w = torch.randn(e, k, n, generator=gen, device="cuda") * 0.02
        dy = (torch.randn(m, n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        no_copy = hasattr(mm, "stacks_transposed")

        def dx():
            wt = w.transpose(1, 2)
            return mm.moe_grouped_matmul(dy, wt if no_copy else wt.contiguous(), gsz)

        def dw():
            return mm.grouped_weight_grad(x, dy, gsz, e)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        r = {"forward": graph_ms(lambda: mm.moe_grouped_matmul(x, w, gsz), reps=3),
             "dx": graph_ms(dx, reps=3), "dw": graph_ms(dw, reps=3),
             "backward": graph_ms(lambda: (dx(), dw()), reps=3),
             "fwd_bwd_eager": eager_ms(lambda: torch.autograd.grad(
                 mm.moe_grouped_matmul(xg, wg, gsz), (xg, wg), dy))}
        if no_copy:
            # the stack kernel alone over all 2,048 rows in one call (no
            # chunking), forward and dx, on the padded layout
            xp, _, texp, used = mm.scatter_layout(x, gsz, 128, e)
            dyp = mm.scatter_layout(dy, gsz, 128, e)[0]
            rows = mm.tile_rows(gsz, texp, 128)
            r["forward_kernel_one_call"] = graph_ms(
                lambda: mm.grouped_padded(xp, w, None, texp, used, 128, True, rows), reps=3)
            r["dx_kernel_one_call"] = graph_ms(
                lambda: mm.grouped_padded(dyp, w.transpose(1, 2), None, texp, used, 128, True,
                                          rows), reps=3)
            del xp, dyp
        if hasattr(torch, "_grouped_mm"):
            r["cast"] = graph_ms(lambda: w.to(torch.bfloat16), reps=3)
            wb = torch.empty((e, n, k), dtype=torch.bfloat16, device="cuda")

            def cast_grouped_mm():
                # one pass casts the stacks to bf16 in the (n, k) layout
                # _grouped_mm takes its stacks in
                wb.copy_(w.transpose(1, 2))
                return torch._grouped_mm(x, wb.transpose(1, 2), offs=offs)
            r["cast_grouped_mm"] = graph_ms(cast_grouped_mm, reps=3)
            r["grouped_mm_precast"] = graph_ms(
                lambda: torch._grouped_mm(x, wb.transpose(1, 2), offs=offs), reps=3)
            del wb
        out[proj] = r
        del x, w, dy, xg, wg
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("moe_times: no CUDA device; this tool runs on a GPU only")
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    if os.path.dirname(os.path.dirname(os.path.abspath(mm.__file__))) != \
            os.path.join(tree, "ragmeup_tpu_torch"):
        raise SystemExit(f"moe_times: imported {mm.__file__}, not {tree}'s")
    kernels.lib()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    if args.train:
        print(json.dumps({"tree": tree, "train_graph_ms": train_times(mm)}), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    mixtral = experts(gen, 8, MIXTRAL)
    qwen = experts(gen, 128, QWEN3)
    xs2 = {k: torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
           for k in (4096, 14336)}
    xq = {k: torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (2048, 768)}
    ids2 = torch.tensor([5, 2], device="cuda")
    qids = torch.randperm(128, generator=gen, device="cuda")[:8]

    def gather_layer(weights, xs, ids):
        return lambda: [mm.moe_gather_matmul(xs[w.shape[1]], w, ids, s)
                        for w, s in weights.values()]
    result = {"tree": tree, "gather_graph_ms": {
        "mixtral_s2": graph_ms(gather_layer(mixtral, xs2, ids2), reps=10),
        "qwen3_s8": graph_ms(gather_layer(qwen, xq, qids), reps=10)}}

    gsz = torch.tensor(GROUPS, device="cuda")
    xs16 = {k: torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
            for k in (4096, 14336)}

    def grouped_times(weights) -> dict:
        times = {"function": graph_ms(lambda: [
            mm.moe_grouped_matmul(xs16[w.shape[1]], w, gsz, s, **DEDUP)
            for w, s in weights.values()], reps=5)}
        if hasattr(mm, "grouped_rows"):
            times["kernel"] = graph_ms(lambda: [mm.grouped_rows(xs16[w.shape[1]], w, s, gsz)
                                                for w, s in weights.values()], reps=5)
        else:
            padded = {k: mm.scatter_layout(x, gsz, 16, 8) for k, x in xs16.items()}
            times["kernel"] = graph_ms(lambda: [
                mm.grouped_padded(padded[w.shape[1]][0], w, s, padded[w.shape[1]][2],
                                  padded[w.shape[1]][3], 16, stack=False)
                for w, s in weights.values()], reps=5)
        return times
    result["grouped_graph_ms"] = {"int8": grouped_times(mixtral)}
    if args.stream:
        result["stream_graph_ms"] = stream_times(tree, mm, gen, mixtral, qwen, xs16)
    del mixtral, qwen
    torch.cuda.empty_cache()
    bf16 = experts(gen, 8, MIXTRAL, "bf16")
    result["grouped_graph_ms"]["bf16"] = grouped_times(bf16)
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gsz, 0).to(torch.int32)
        stacks = [w.transpose(1, 2).contiguous().transpose(1, 2) for w, _ in bf16.values()]
        result["grouped_mm_bf16_ms"] = graph_ms(lambda: [
            torch._grouped_mm(xs16[w.shape[1]], w, offs=offs) for w in stacks], reps=5)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
