"""The /chat paths of the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels of ragmeup_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, with the stated tolerance; median times of
   both, and of one PyTorch library call computing the same function where
   there is one, from CUDA events, each after warm-up rounds until two
   agree within 5 %; the kernel's time also from a CUDA graph's replay
   (graph_ms: the device's time without the wrapper's host cost, which an
   eager loop times once it exceeds the kernel's); the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type); the card's SM and memory clocks before the checks and after
   each.
4. system, default path: full-width models with random weights drawn on
   the card from --seed (GIST-small-shaped encoder, MiniLM-L-6-shaped
   cross-encoder, Llama-3.1-8B-shaped int8 decoder), a generated corpus of
   N_DOCS short documents (16 top-k tiles of 1024), RagSystem ingest →
   embed → index, then three chat() requests on the default config (hybrid
   0.5/0.5, MMR, bf16 index, rerank, rewrite loop, Re2, rerank provenance)
   with MAX_NEW_TOKENS per answer; the third sends history.
5. system, quantized path: the int8 decoder is freed; an int4 W4A16
   Llama-3.1-8B-shaped decoder (128-row scale groups) and a RagSystem with
   an int8 dense index over the same corpus answer three chat() requests;
   then an int4 W4A8 decoder (512-row groups) on a second RagSystem, which
   loads the saved int8 index artifact, answers one.
6. system, batched path (run right after phase 4, on its int8 decoder and
   index artifact): a RagSystem with server.batched_llm serves /chat
   through the paged engine (512 pages of 128 tokens per layer, 8-step
   waves, prefix cache, temperature 0.2): four first turns sent at once
   from four threads, then a follow-up with history. Prints the backend's
   TTFT and tok/s percentiles and the engine's wave timings; checks the
   prefix-cache hits and that every page is free or registered after stop.
7. system, sparse-MoE path: the int4 decoders are freed; a
   Mixtral-8x7B-shaped int8 decoder (8 experts, top-2; 47.5 GB) with the
   bf16 index of phase 4 answers three chat() requests ("moe": decode
   through #10, prefill through the all-experts einsum); a second decoder
   over the same weights with moe_grouped="on" answers one ("moe
   grouped": prefill through #12); then the paged engine on the first
   serves eight first turns at once and a follow-up ("moe batched": waves
   of 8 rows, 16 (token, expert) slots, through #11). Decode against
   prefill compares the last token's routed experts layer by layer.
8. system, int4 sparse-MoE path: the int8 Mixtral decoder is freed; the
   same shape with packed int4 experts (group 128; about 25 GB) answers
   three chat() requests ("moe int4": decode through #13, prefill through
   the stacks dequantized in bf16), then serves eight first turns at once
   and a follow-up through the paged engine ("moe int4 batched": 8-row
   waves through #14); a W4A8 int4 decoder (512-row groups) answers one
   ("moe int4 W4A8": #5 and #13's output-scaled route). #6 (the fused int4
   MLP) is on no path, as in the JAX package: phase 3 checks it alone.

Each LLM call of phases 4-5 and 7-8 is timed on its own. Each of the ten
runs of requests resets the kernels' launch counts just before its
requests and reads them just after; every kernel of that run's path must
have launched.

Prints a JSON line with the kernels' results and the clocks read before
and after phase 3, then the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

N_DOCS = 16384          # 16 top-k tiles of 1024 columns
MAX_NEW_TOKENS = 32     # generation.max_new_tokens of the answer

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, rounds: int = 5, warm_rounds: int = 10) -> float:
    """Median over `rounds` of the mean time of `reps` calls (CUDA events),
    after warm-up rounds until two in a row agree within 5 % (at most
    `warm_rounds`), so a card still raising its clocks is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()

    def one_round() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph and the replay timed by median_ms. The host's cost of enqueueing
    a call (the wrappers' checks, allocations and the ctypes launch, some
    20-40 us) exceeds the device time of the fastest kernels, and an eager
    loop then times the host; the replay does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, reps=1) / reps


def graph_ms_or_none(what: str, fn, reps: int = 10):
    """graph_ms, or None (logged) where a call cannot be captured."""
    try:
        return graph_ms(fn, reps)
    except Exception as exc:  # a second timing; its failure is printed
        log(f"  {what}: no graph timing ({type(exc).__name__}: {str(exc).splitlines()[0][:160]})")
        return None


def clocks() -> str:
    """The card's SM and memory clocks now, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def stamped(result: dict) -> dict:
    """A kernel check's result with the clocks read just after its timings."""
    return dict(result, clocks_sm_mem_after=clocks())


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take for work that must move `nbytes`
    (each input read once, each output written once) and do `ops`
    operations of type `kind`: the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log_ptxas(build_log: str) -> None:
    """Each kernel's registers and shared memory from nvcc's -Xptxas -v
    report, and any spill: a line per kernel, named."""
    fn = "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif "registers" in line:
            log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
        elif re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
            log(f"  ptxas {fn} SPILLS: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def topk_corpus(gen, n_cols: int, d: int = 384):
    """Unit rows (n_cols, d) with exact duplicates (the lowest index must
    win the ties) and an additive mask with a padding tail and 500 dead
    columns."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    c = torch.randn(n_cols, d, generator=gen, device="cuda")
    c = c / c.norm(dim=1, keepdim=True)
    c[100:110] = c[50]
    mask = torch.zeros(1, n_cols, device="cuda")
    mask[0, n_cols - 300:] = topk.NEG_INF                 # padding tail
    mask[0, torch.randperm(n_cols - 300, generator=gen, device="cuda")[:500]] = topk.NEG_INF
    return c, mask


def check_topk(gen, n_cols: int) -> dict:
    """#1 at the retrieval shapes: d = 384, the smoke corpus capacity, dead
    and padding columns, exact duplicates. Ids must match exactly; scores
    to 1e-5 (bf16 products are exact in f32, only the sum order differs)."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    d = 384
    c, mask = topk_corpus(gen, n_cols, d)
    corpus_t = c.T.contiguous().to(torch.bfloat16)
    err = 0.0
    for b in (1, 8):
        q = torch.randn(b, d, generator=gen, device="cuda")
        q[0] = c[50]
        for k in (10, 20):
            s1, i1 = topk.dense_topk(q, corpus_t, k, mask=mask)
            s0, i0 = topk.dense_topk_plain(q, corpus_t, k, mask=mask)
            torch.cuda.synchronize()
            if not torch.equal(i0, i1):
                raise AssertionError(f"topk ids differ at b={b} k={k}:\n{i0}\n{i1}")
            err = max(err, (s0 - s1).abs().max().item())
    if err > 1e-5:
        raise AssertionError(f"topk scores differ by {err}")
    q = torch.randn(1, d, generator=gen, device="cuda")
    qb = q.to(torch.bfloat16)
    return {"max_abs_err": err,
            "ms": median_ms(lambda: topk.dense_topk(q, corpus_t, 20, mask=mask)),
            "graph_ms": graph_ms_or_none("topk", lambda: topk.dense_topk(q, corpus_t, 20,
                                                                         mask=mask)),
            "plain_ms": median_ms(lambda: topk.dense_topk_plain(q, corpus_t, 20, mask=mask)),
            # the library yardstick: torch.topk after the matmul
            "library_ms": median_ms(lambda: torch.topk(
                (qb @ corpus_t).float() + mask, 20)),
            **bound(nbytes(q, corpus_t, mask) + 20 * 8, 2 * d * n_cols, "bf16"),
            "shape": f"b=1 d={d} N={n_cols} k=20 bf16"}


def check_topk_int8(gen, n_cols: int) -> dict:
    """#2 at the int8 retrieval shapes: the corpus quantized per row as the
    int8 index stores it, d = 384, the smoke corpus capacity, b in {1, 8},
    k in {10, 20}. Ids must match exactly and scores be equal: the int8 dot
    is exact in both versions and the epilogue rounds in the same order."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    d = 384
    c, mask = topk_corpus(gen, n_cols, d)
    codes, scales = topk.quantize_int8(c, axis=1)
    corpus, c_scale = codes.T.contiguous(), scales.T.contiguous()
    err = 0.0
    for b in (1, 8):
        q = torch.randn(b, d, generator=gen, device="cuda")
        q[0] = c[50]
        for k in (10, 20):
            s1, i1 = topk.dense_topk_int8(q, corpus, c_scale, k, mask=mask)
            s0, i0 = topk.dense_topk_int8_plain(q, corpus, c_scale, k, mask=mask)
            torch.cuda.synchronize()
            if not torch.equal(i0, i1):
                raise AssertionError(f"topk_int8 ids differ at b={b} k={k}:\n{i0}\n{i1}")
            err = max(err, (s0 - s1).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"topk_int8 scores differ by {err}")
    q = torch.randn(1, d, generator=gen, device="cuda")
    return {"max_abs_err": err,
            "ms": median_ms(lambda: topk.dense_topk_int8(q, corpus, c_scale, 20, mask=mask)),
            "graph_ms": graph_ms_or_none("topk_int8", lambda: topk.dense_topk_int8(
                q, corpus, c_scale, 20, mask=mask)),
            "plain_ms": median_ms(lambda: topk.dense_topk_int8_plain(
                q, corpus, c_scale, 20, mask=mask)),
            "library_ms": None,  # no one PyTorch call scores int8 codes and ranks
            **bound(nbytes(q, corpus, c_scale, mask) + 20 * 8, 2 * d * n_cols, "int8"),
            "shape": f"b=1 d={d} N={n_cols} k=20 int8"}


DECODE_SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
                 "o": (4096, 4096), "gate": (4096, 14336), "up": (4096, 14336),
                 "down": (14336, 4096)}


def check_int8_matmul(gen) -> dict:
    """#3 at the 8B decode projections, m in {1, 8}, bf16. Tolerance: one
    bf16 ulp of the largest output (2^-7 * max |ref|): both sides sum in
    f32 and round once. Times: the 7 projections of one layer in sequence
    (218 MB of int8, beyond the 50 MB L2, as decode reads it) at m = 1 and
    m = 8, from an eager loop and from a CUDA graph's replay (graph_ms: the
    device's time without the wrapper's host cost); each projection alone
    at m = 1, eager (L2-warm: q, k, v and o fit in the L2) and in a graph
    over copies of its weights that exceed the L2, with its bound, plain
    time and split-K slices. The library
    yardstick is torch._weight_int8pack_mm over the same layer (weights
    (n, k), bf16 scales, prepared outside the timing; the port never calls
    it), with its error against the plain version beside it."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    weights = {}
    err = 0.0
    for name, (k, n) in DECODE_SHAPES.items():
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(n, generator=gen, device="cuda") * 2e-4 + 1e-4
        weights[name] = (w, s)
        if name in ("v", "o", "up"):
            continue  # same (k, n) as a projection checked already
        for m in (1, 8):
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            y1 = qm.int8_matmul(x, w, s)
            y0 = qm.int8_matmul_plain(x, w, s)
            torch.cuda.synchronize()
            diff = (y0.float() - y1.float()).abs().max().item()
            tol = 2.0 ** -7 * y0.float().abs().max().item()
            if not diff <= tol:
                raise AssertionError(f"int8_matmul {name} m={m}: {diff} > {tol}")
            err = max(err, diff)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xs = {m: {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)} for m in (1, 8)}

    def layer(fn, m=1):
        return lambda: [fn(xs[m][w.shape[0]], w, s) for w, s in weights.values()]
    per_shape = {}
    for name, (w, s) in weights.items():
        k, n = w.shape
        x = xs[1][k]
        # device time over copies of the weights that exceed the L2 together
        copies = [(w, s)] + [(w.clone(), s) for _ in range(-(-64 * 2**20 // w.numel()) - 1)]
        per_shape[name] = {
            "ms": median_ms(lambda w=w, s=s, x=x: qm.int8_matmul(x, w, s)),
            "graph_ms": graph_ms(lambda: [qm.int8_matmul(x, wc, sc) for wc, sc in copies],
                                 reps=4) / len(copies),
            "plain_ms": median_ms(lambda w=w, s=s, x=x: qm.int8_matmul_plain(x, w, s), reps=5),
            **bound(nbytes(w, s) + 2 * (k + n), 2 * k * n, "bf16"),
            "slices": len(qm.int8_slices(k, qm.int8_matmul_plan(1, k, n, sms)))}
        del copies
    moved = sum(nbytes(w, s) + 2 * (w.shape[0] + w.shape[1]) for w, s in weights.values())
    ops = sum(2 * w.shape[0] * w.shape[1] for w, _ in weights.values())
    library, library_graph, library_err, refusal = None, None, None, None
    try:
        packed = [(w.t().contiguous(), s.to(torch.bfloat16)) for w, s in weights.values()]

        def run_library():
            return [torch._weight_int8pack_mm(xs[1][wt.shape[1]], wt, sb) for wt, sb in packed]
        library_err = max((got.float() - qm.int8_matmul_plain(xs[1][w.shape[0]], w, s).float())
                          .abs().max().item()
                          for got, (w, s) in zip(run_library(), weights.values()))
        library = median_ms(run_library, reps=10)
        library_graph = graph_ms(run_library, reps=4)
        del packed
    except Exception as exc:  # the yardstick is optional; its refusal is printed
        refusal = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log(f"  torch._weight_int8pack_mm refused: {refusal}")
    log(f"  int8_matmul library yardstick torch._weight_int8pack_mm: {library} ms "
        f"(graph {library_graph}), error against the plain version {library_err}")
    return {"max_abs_err": err, "ms": median_ms(layer(qm.int8_matmul), reps=10),
            "graph_ms": graph_ms(layer(qm.int8_matmul), reps=4),
            "plain_ms": median_ms(layer(qm.int8_matmul_plain), reps=10),
            "library_ms": library, "library_graph_ms": library_graph,
            "library_call": "torch._weight_int8pack_mm",
            "library_err": library_err, "library_refusal": refusal,
            **bound(moved, ops, "bf16"),
            "shape": "one decode layer: 7 projections at m=1, bf16",
            "m8": {"ms": median_ms(layer(qm.int8_matmul, 8), reps=10),
                   "graph_ms": graph_ms(layer(qm.int8_matmul, 8), reps=4),
                   **bound(sum(nbytes(w, s) + 2 * 8 * (w.shape[0] + w.shape[1])
                               for w, s in weights.values()), 8 * ops, "bf16")},
            "per_shape_m1": per_shape}


def int4pack_ms(xs, weights, group: int, plain) -> tuple:
    """torch._weight_int4pack_mm over a layer's projections at group
    `group`: the same signed nibbles + 8 packed by
    torch._convert_weight_to_int4pack, bf16 group scales with zero 0, all
    prepared outside the timing (a yardstick: the port never calls it).
    Returns (ms, error against the plain version, refusal, graph ms)."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    try:
        packed = []
        for w, s in weights:
            k = 2 * w.shape[0]
            u = (qm.unpack_int4(w, qm.int4_tiling(k)[0]).to(torch.int32) + 8).t().contiguous()
            w_u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            qsz = torch.stack([s.to(torch.bfloat16), torch.zeros_like(s, dtype=torch.bfloat16)],
                              dim=2).contiguous()
            packed.append((k, torch._convert_weight_to_int4pack(w_u8, 8), qsz))
            del u, w_u8

        def run():
            return [torch._weight_int4pack_mm(xs[k], wp, group, qsz) for k, wp, qsz in packed]
        err = max((got.float() - plain(xs[2 * w.shape[0]], w, s).float()).abs().max().item()
                  for got, (w, s) in zip(run(), weights))
        return median_ms(run, reps=10), err, None, graph_ms(run, reps=4)
    except Exception as exc:  # the yardstick is optional; its refusal is printed
        refusal = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log(f"  torch._weight_int4pack_mm refused: {refusal}")
        return None, None, refusal, None


def check_int4(gen, a8: bool) -> dict:
    """#4 (W4A16, groups 128 and 512: the quality and the output-scaled
    route) or #5 (W4A8, group 512) at the 8B projection shapes for m in
    {1, 8, 256}, bf16, on random packed bytes and scales. Tolerance: one
    bf16 ulp of the largest output (2^-7 * max |ref|): both versions sum in
    f32 and round once (W4A8: exact integer sums, the same epilogue order).
    Times: the 7 projections of one layer in sequence at m = 1 (109 MB of
    packed int4, beyond the 50 MB L2, as decode reads it) and at m = 256;
    #4's library yardstick is torch._weight_int4pack_mm over the group-128
    layer at m = 1 (int4pack_ms)."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    plain = qm.int4_matmul_a8_plain if a8 else qm.int4_matmul_plain

    def kernel(x, w, s):
        return qm.int4_matmul(x, w, s, a8=a8)
    err, times, moved = 0.0, {}, {}
    for group in (512,) if a8 else (128, 512):
        weights = {}
        for name, (k, n) in DECODE_SHAPES.items():
            w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.int8)
            s = torch.rand(k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3
            weights[name] = (w, s)
            if name in ("v", "o", "up"):
                continue  # same (k, n) as a projection checked already
            for m in (1, 8, 256):
                x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                y1 = kernel(x, w, s)
                y0 = plain(x, w, s)
                torch.cuda.synchronize()
                diff = (y0.float() - y1.float()).abs().max().item()
                tol = 2.0 ** -7 * y0.float().abs().max().item()
                if not diff <= tol:
                    raise AssertionError(f"int4 a8={a8} group={group} {name} m={m}: "
                                         f"{diff} > {tol}")
                err = max(err, diff)
        moved[group] = sum(nbytes(w, s) + 2 * (2 * w.shape[0] + w.shape[1])
                           for w, s in weights.values())
        if group == (512 if a8 else 128):
            xs1 = {k: torch.randn(1, k, generator=gen, device="cuda").to(torch.bfloat16)
                   for k in (4096, 14336)}
            kernel_graph = graph_ms(lambda: [kernel(xs1[2 * w.shape[0]], w, s)
                                             for w, s in weights.values()], reps=4)
        if not a8 and group == 128:
            library = int4pack_ms(xs1, list(weights.values()), group, plain)
            log(f"  int4_matmul library yardstick torch._weight_int4pack_mm (group 128): "
                f"{library[0]} ms (graph {library[3]}), error against the plain version "
                f"{library[1]}; the kernel's layer in a graph {kernel_graph} ms")
        for m in (1, 256):
            xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k in (4096, 14336)}

            def layer(fn, xs=xs, weights=weights):
                return lambda: [fn(xs[2 * w.shape[0]], w, s) for w, s in weights.values()]
            reps = 10 if m == 1 else 2
            times[f"group{group}_m{m}"] = (median_ms(layer(kernel), reps=reps),
                                           median_ms(layer(plain), reps=reps))
    ms, plain_ms = times["group512_m1" if a8 else "group128_m1"]
    ops = sum(2 * (2 * k) * n for k, n in
              ((w.shape[0], w.shape[1]) for w, _ in weights.values()))
    lib = {"library_ms": None, "graph_ms": kernel_graph}  # W4A8: no one PyTorch call
    if not a8:
        lib = {"library_ms": library[0], "library_graph_ms": library[3],
               "graph_ms": kernel_graph, "library_call": "torch._weight_int4pack_mm",
               "library_err": library[1], "library_refusal": library[2]}
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **lib,
            **bound(moved[512 if a8 else 128], ops, "int8" if a8 else "bf16"),
            "shape": f"one decode layer: 7 projections at m=1, bf16, group "
                     f"{512 if a8 else 128}",
            "layer_ms_kernel_plain": {k: [round(a, 4), round(b, 4)]
                                      for k, (a, b) in times.items()}}


def check_flash(gen) -> dict:
    """#8 at an 8B prefill (nkv 8, g 4, hd 128, s 1024, kv_len 2048, bf16)
    and #7, its g = 1 case, at a multi-head one (32 heads); a ragged shape
    (s 200, kv_len 256, g 4 and g 1); f32 inputs (the scalar kernel) at a
    small shape. Each call must launch the kernel. Tolerance 2e-2 absolute:
    the bf16 kernel rounds the unnormalized P (each p <= 1) to bf16 before
    P V, as the JAX kernel does (p.astype(v.dtype)), while the plain
    version keeps f32 throughout; that costs at most about 2^-9 * max |v|
    (|v| < 5 here), plus the output's final rounding, one bf16 ulp at
    |out| < 2. Times at both prefill buckets the paths use (s 1024 and s 256,
    kv_len 2048), each beside its bound and scaled_dot_product_attention."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import attention

    def inputs(bkv, g, s, kv_len, dtype=torch.bfloat16):
        q = torch.randn(bkv, g, s, 128, generator=gen, device="cuda").to(dtype)
        k = torch.randn(bkv, kv_len, 128, generator=gen, device="cuda").to(dtype)
        v = torch.randn(bkv, kv_len, 128, generator=gen, device="cuda").to(dtype)
        return q, k, v

    def held(what, q, k, v):
        before = kernels.launch_counts()["flash_gqa"]
        o1 = attention.flash_attention_gqa(q, k, v)
        if kernels.launch_counts()["flash_gqa"] == before:
            raise AssertionError(f"flash_attention_gqa {what}: the kernel did not launch")
        o0 = attention.flash_attention_gqa_plain(q, k, v)
        torch.cuda.synchronize()
        err = (o0.float() - o1.float()).abs().max().item()
        if not (err <= 2e-2 and torch.isfinite(o1).all()):
            raise AssertionError(f"flash_attention_gqa {what} differs by {err}")
        return err

    def timed(q, k, v):
        # causal: the function reads keys 0..s-1 only; 4 flops per (query,
        # key) pair and head dim (two products)
        bkv, g, s, _ = q.shape
        pairs = bkv * g * s * (s + 1) // 2
        kq, vq = k[:, None, :s], v[:, None, :s]
        return {"ms": median_ms(lambda: attention.flash_attention_gqa(q, k, v), reps=5),
                "graph_ms": graph_ms_or_none("flash_gqa", lambda: attention.flash_attention_gqa(
                    q, k, v), reps=5),
                "plain_ms": median_ms(lambda: attention.flash_attention_gqa_plain(q, k, v),
                                      reps=5),
                "library_ms": median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kq, vq, is_causal=True, enable_gqa=True), reps=5),
                **bound(2 * nbytes(q) + nbytes(kq, vq), 4 * pairs * 128, "bf16")}

    main = inputs(8, 4, 1024, 2048)
    err = held("g=4 s=1024", *main)
    g1 = inputs(32, 1, 1024, 2048)
    err = max(err, held("g=1 s=1024", *g1))
    for g, bkv in ((4, 2), (1, 8)):
        err = max(err, held(f"ragged g={g} s=200 kv_len=256", *inputs(bkv, g, 200, 256)))
    f32_err = held("f32 g=4 s=200", *inputs(2, 4, 200, 256, torch.float32))
    s256 = inputs(8, 4, 256, 2048)
    err = max(err, held("g=4 s=256", *s256))
    return {"max_abs_err": err, **timed(*main),
            "shape": "bkv=8 g=4 s=1024 kv_len=2048 hd=128 bf16",
            "g1_bkv32_s1024": timed(*g1), "g4_s256": timed(*s256), "f32_err": f32_err}


def paged_inputs(gen, b: int, lengths, q_len: int, nh: int = 32, nkv: int = 8,
                 P: int = 512, ps: int = 128, mp: int = 16):
    """q (b, q_len, nh, 128) and a bf16 pool (nkv, P, ps, 128) at the 8B
    serving shapes; each sequence's mp-page table holds distinct pages
    scattered over the pool (entries past its length too, which the kernel
    must not read)."""
    import torch
    q = torch.randn(b, q_len, nh, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(nkv, P, ps, 128, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(nkv, P, ps, 128, generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randperm(P, generator=gen, device="cuda")[:b * mp].reshape(b, mp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, idx.to(torch.int32), lens


def check_paged(gen) -> dict:
    """#9 in both modes at the 8B serving shapes (nh 32, nkv 8, hd 128, bf16;
    128-token pages, 16-page tables over a 512-page pool unless stated).
    Decode: 8 sequences of 1 to 2048 tokens; one of 2048; four of 1024 to
    2048 (the batched run's shape). Chunk-append: a 128-token chunk for 1
    and for 4 sequences after prefixes of 0 to 1920 tokens. Both modes also
    with window 512, with softcap 30, and over 16-token pages (128-page
    tables). Tolerance, element by element: two bf16 ulps of the largest
    |output| of the element's own (sequence, query, head) row (both versions
    sum in f32 and round once to bf16, in another order; the chunk kernel
    carries p as two bf16 parts, about 2^-16 relative). Per row, because a
    one-key row outputs a raw V row several times larger than a 2048-key
    row's average: a tolerance set by it would pass a long row with its tail
    page dropped; the decode check shows that this one does not. Each timed
    case is timed eagerly and in a CUDA graph (graph_ms, without the
    wrapper's host cost) and prints its split count (the plan reads the
    shapes and the SM count). Returns the decode and the chunk entries."""
    import torch
    from ragmeup_tpu_torch.ops import paged_attention as pa
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def off(out, ref):
        """|out - ref| and where it exceeds two bf16 ulps of the row's
        largest |ref| (0 for an all-zero row) or is not finite."""
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        big = ref.abs().amax(-1, keepdim=True)
        tol = 2.0 * torch.exp2(torch.floor(torch.log2(big)) - 7)
        return err, (err > tol) | ~torch.isfinite(out)

    def compare(name, out, ref):
        torch.cuda.synchronize()
        err, bad = off(out, ref)
        if bad.any():
            at = tuple(bad.nonzero()[0].tolist())
            raise AssertionError(
                f"{name} differs from its plain version at {at} by "
                f"{err[at].item()}, beyond two bf16 ulps of its row's largest output")
        return err.max().item()

    def case(label, b, lengths, q_len, ps=128, mp=16, timed=False, **kw):
        """One check against the plain version; with `timed`, the kernel's
        and the plain version's times, the bound and the split count."""
        q, k, v, idx, lens = paged_inputs(gen, b, lengths, q_len, ps=ps, mp=mp,
                                          P=max(512, b * mp))
        if q_len == 1:
            q = q[:, 0].contiguous()
            fn, plain = pa.paged_attention, pa.paged_attention_plain
        else:
            fn, plain = pa.paged_attention_chunk, pa.paged_attention_chunk_plain
        name = f"{fn.__name__} {label}"
        err = compare(name, fn(q, k, v, idx, lens, **kw), plain(q, k, v, idx, lens, **kw))
        splits = pa.paged_splits(mp, ps, pa.kernel_split(b, q_len, 32, 8, ps, mp,
                                                         torch.bfloat16, sms))
        res = {"max_abs_err": err, "splits": splits}
        if timed:
            # K/V rows read once per kv head; 4 flops per (query row, key, dim)
            pairs = sum(q_len * (n - q_len) + q_len * (q_len + 1) // 2 for n in lengths)
            res.update(ms=median_ms(lambda: fn(q, k, v, idx, lens, **kw)),
                       graph_ms=graph_ms(lambda: fn(q, k, v, idx, lens, **kw)),
                       plain_ms=median_ms(lambda: plain(q, k, v, idx, lens, **kw), reps=5),
                       **bound(2 * sum(lengths) * 8 * 128 * 2 + 2 * nbytes(q) + nbytes(idx, lens),
                               4 * pairs * 32 * 128, "bf16"))
            log(f"  {name}: {res['ms']:.4f} ms, graph {res['graph_ms']:.4f} (plain "
                f"{res['plain_ms']:.4f}, bound {res['bound_ms']:.4f}), {splits} splits")
        return res, (q, k, v, idx, lens)

    lengths = [1, 2048, 777, 128, 129, 1500, 64, 1024]
    decode, (qd, k, v, idx, lens) = case("b=8", 8, lengths, 1, timed=True)
    # the tolerance must catch a kernel that drops each long sequence's tail page
    ref = pa.paged_attention_plain(qd, k, v, idx, lens)
    cut = torch.tensor([n - ((n - 1) % 128 + 1) if n > 128 else n for n in lengths],
                       dtype=torch.int32, device="cuda")
    caught = off(pa.paged_attention_plain(qd, k, v, idx, cut), ref)[1].flatten(1).any(1)
    if not caught[lens > 128].all():
        raise AssertionError("the paged_attention tolerance passes a dropped tail page")
    decode.update(library_ms=None,  # no one PyTorch call reads a paged pool
                  shape=f"b=8 nh=32 nkv=8 hd=128 ps=128 lengths={lengths} bf16")
    decode["b1"] = case("b=1 2048 tokens", 1, [2048], 1, timed=True)[0]
    decode["b4"] = case("b=4", 4, [1024, 1333, 1700, 2048], 1, timed=True)[0]
    chunk = {}
    for prefixes in ([1920], [0, 640, 1333, 1920]):
        b = len(prefixes)
        chunk[b] = case(f"b={b}", b, [p + 128 for p in prefixes], 128, timed=True)[0]
        chunk[b]["prefixes"] = prefixes
    variants = {}
    for label, kw in (("window=512", {"window": 512}), ("softcap=30", {"softcap": 30.0}),
                      ("ps=16", {"ps": 16, "mp": 128})):
        variants[f"decode {label}"] = case(label, 8, lengths, 1, **kw)[0]
        variants[f"chunk {label}"] = case(label, 4, [p + 128 for p in (0, 640, 1333, 1920)],
                                          128, **kw)[0]
    log(f"  paged variants (error, splits): "
        + json.dumps({key: [r["max_abs_err"], r["splits"]] for key, r in variants.items()}))
    err = max(r["max_abs_err"] for r in variants.values())
    decode["max_abs_err"] = max(decode["max_abs_err"], decode["b1"]["max_abs_err"],
                                decode["b4"]["max_abs_err"], err)
    chunk_entry = dict(chunk[4], max_abs_err=max(chunk[1]["max_abs_err"],
                                                 chunk[4]["max_abs_err"], err),
                       library_ms=None,
                       shape="q_len=128 b=4 nh=32 nkv=8 hd=128 ps=128 bf16",
                       b1=chunk[1])
    return {"decode": decode, "chunk": chunk_entry}


# Mixtral-8x7B's expert projections: (k, n) of gate, up and down
MOE_E = 8
MOE_SHAPES = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}


def moe_experts(gen, e: int, k: int, n: int, kind: str):
    """(w, scale): int8 codes with per-expert per-column scales, or float
    experts (bf16 or f32) with no scale."""
    import torch
    if kind == "int8":
        return (torch.randint(-127, 128, (e, k, n), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand(e, n, generator=gen, device="cuda") * 2e-4 + 1e-4)
    w = torch.randn(e, k, n, generator=gen, device="cuda") * 0.02
    return w.to(getattr(torch, kind)), None


def moe_compare(name: str, got, ref) -> float:
    """|got - ref| within one bf16 ulp of the largest |ref| (bf16: both
    sides sum in f32 and round once, in another order) or 1e-5 of it (f32
    activations: only the sum order differs)."""
    import torch
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs().max().item()
    big = ref.float().abs().max().item()
    tol = (2.0 ** -7 if ref.dtype == torch.bfloat16 else 1e-5) * big
    if not (diff <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{name} differs from its plain version by {diff} > {tol}")
    return diff


def check_moe_gather(gen) -> dict:
    """#10 at Mixtral's int8 expert shapes (E 8; gate/up 4096 x 14336, down
    14336 x 4096), S in {2, 16} slots, bf16; float experts at a smaller
    shape (bf16 experts with bf16 x, f32 experts with f32 x). Tolerance:
    moe_compare. Times: one decode layer's three projections at S = 2 (two
    routed experts, 352 MB of int8: beyond the 50 MB L2)."""
    import torch
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    weights = {name: moe_experts(gen, MOE_E, k, n, "int8")
               for name, (k, n) in MOE_SHAPES.items()}
    err = 0.0
    for slots in (2, 16):
        ids = torch.randint(0, MOE_E, (slots,), generator=gen, device="cuda")
        ids[:2] = torch.tensor([5, 2])
        for name in ("gate", "down"):
            w, s = weights[name]
            x = torch.randn(slots, w.shape[1], generator=gen, device="cuda").to(torch.bfloat16)
            err = max(err, moe_compare(f"moe_gather {name} S={slots}",
                                       mm.moe_gather_matmul(x, w, ids, s),
                                       mm.moe_gather_matmul_plain(x, w, ids, s)))
    for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        w, _ = moe_experts(gen, MOE_E, 1024, 2048, kind)
        x = torch.randn(16, 1024, generator=gen, device="cuda").to(dtype)
        ids = torch.randint(0, MOE_E, (16,), generator=gen, device="cuda")
        moe_compare(f"moe_gather {kind} experts", mm.moe_gather_matmul(x, w, ids),
                    mm.moe_gather_matmul_plain(x, w, ids))
    ids = torch.tensor([5, 2], device="cuda")
    xs = {k: torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}

    def layer(fn):
        return lambda: [fn(xs[w.shape[1]], w, ids, s) for w, s in weights.values()]
    moved = sum(2 * (w.shape[1] * w.shape[2] + 4 * w.shape[2])
                + nbytes(xs[w.shape[1]]) + 2 * 2 * w.shape[2] for w, _ in weights.values())
    ops = sum(2 * 2 * w.shape[1] * w.shape[2] for w, _ in weights.values())
    return {"max_abs_err": err, "ms": median_ms(layer(mm.moe_gather_matmul), reps=10),
            "graph_ms": graph_ms_or_none("moe_gather", layer(mm.moe_gather_matmul), reps=4),
            "plain_ms": median_ms(layer(mm.moe_gather_matmul_plain), reps=2),
            "library_ms": None,  # no one PyTorch call gathers experts and multiplies
            **bound(moved, ops, "bf16"),
            "shape": "one Mixtral decode layer: gate, up, down at S=2 slots (experts 5, 2), "
                     "int8 experts, bf16"}


def grouped_mm_ms(xs, weights, gsz):
    """torch._grouped_mm on the bf16-dequantized stacks, where the card's
    torch has it (a yardstick, not the same function: int8 codes are
    widened to bf16 first, outside the timing); None otherwise."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None
    offs = torch.cumsum(gsz, 0).to(torch.int32)
    stacks = [((w.to(torch.bfloat16) * (1 if s is None else s[:, None, :].to(torch.bfloat16)))
               .transpose(1, 2).contiguous().transpose(1, 2)) for w, s in weights]
    try:
        def run():
            return [torch._grouped_mm(xs[w.shape[1]], w, offs=offs) for w in stacks]
        run()
        return median_ms(run, reps=5)
    except Exception as exc:  # the yardstick is optional; its refusal is logged
        log(f"  torch._grouped_mm refused: {str(exc).splitlines()[0][:120]}")
        return None


def check_moe_grouped(gen) -> dict:
    """#11 on the dedup route (16 slots sorted by expert, expert 2 with no
    rows, 16-row tiles, no_stack) and #12 on the full-stack route (a
    prefill chunk of 1032 rows over all 8 experts, 128-row tiles), at
    Mixtral's int8 expert shapes, bf16; both routes also with bf16 experts
    and with f32 experts and activations at a smaller shape. Held to the
    plain version of the whole grouped product (no padded layout) with
    moe_compare. Times: one layer's three projections on each route.
    Bounds count the experts this data routes to and its real rows."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    weights = {name: moe_experts(gen, MOE_E, k, n, "int8")
               for name, (k, n) in MOE_SHAPES.items()}
    routes = {"moe_grouped": (torch.tensor([3, 2, 0, 4, 1, 2, 3, 1]),
                              dict(tm=16, tile_k=2048, tile_n=1024, no_stack=True)),
              "moe_grouped_stack": (torch.tensor([100, 180, 90, 150, 120, 132, 160, 100]),
                                    {})}
    out = {}
    for name, (gsz, kw) in routes.items():
        gsz = gsz.cuda()
        m = int(gsz.sum())
        xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)}
        err = 0.0
        for proj in ("gate", "down"):
            w, s = weights[proj]
            before = kernels.launch_counts()[name]
            got = mm.moe_grouped_matmul(xs[w.shape[1]], w, gsz, s, **kw)
            if kernels.launch_counts()[name] == before:
                raise AssertionError(f"{name}: the {proj} call took another route")
            err = max(err, moe_compare(f"{name} {proj}", got,
                                       mm.moe_grouped_matmul_plain(xs[w.shape[1]], w, gsz, s)))
        for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            w, _ = moe_experts(gen, MOE_E, 1024, 2048, kind)
            x = torch.randn(m, 1024, generator=gen, device="cuda").to(dtype)
            fkw = dict(kw, tm=8) if kw and dtype == torch.float32 else kw
            moe_compare(f"{name} {kind} experts", mm.moe_grouped_matmul(x, w, gsz, **fkw),
                        mm.moe_grouped_matmul_plain(x, w, gsz))

        def layer(fn, kw=kw):
            return lambda: [fn(xs[w.shape[1]], w, gsz, s, **kw) for w, s in weights.values()]
        used = int((gsz > 0).sum())
        moved = sum(used * (w.shape[1] * w.shape[2] + 4 * w.shape[2])
                    + nbytes(xs[w.shape[1]]) + 2 * m * w.shape[2] for w, _ in weights.values())
        ops = sum(2 * m * w.shape[1] * w.shape[2] for w, _ in weights.values())
        out[name] = {
            "max_abs_err": err,
            "ms": median_ms(layer(mm.moe_grouped_matmul), reps=5),
            "graph_ms": graph_ms_or_none(name, layer(mm.moe_grouped_matmul), reps=2),
            "plain_ms": median_ms(layer(lambda x, w, g, s, **_: mm.moe_grouped_matmul_plain(
                x, w, g, s)), reps=2),
            "library_ms": None,  # PyTorch has no int8-weight grouped matmul
            "grouped_mm_bf16_ms": grouped_mm_ms(xs, weights.values(), gsz),
            **bound(moved, ops, "bf16"),
            "shape": f"one Mixtral layer: gate, up, down over {m} rows sorted by expert, "
                     f"group sizes {gsz.tolist()}, int8 experts, bf16"}
    return out


def int4_experts(gen, e: int, k: int, n: int, group: int):
    """Packed int4 experts (E, k/2, n) of random bytes (every byte is two
    valid nibbles) with group scales (E, k/group, n) of 1e-3 to 3e-3."""
    import torch
    return (torch.randint(-128, 128, (e, k // 2, n), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(e, k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3)


def check_moe_gather_int4(gen) -> dict:
    """#13 at Mixtral's expert shapes (E 8; gate/up 4096 x 14336, down
    14336 x 4096), 2 slots (experts 5 and 2), bf16, for group 128 (weights
    dequantized and rounded) and group 512 (the k-tile: the output-scaled
    route), and with f32 activations at a smaller shape. Tolerance:
    moe_compare; on the output-scaled route the kernel scales each split-K
    slice's partial before the slices are added, one more f32 rounding than
    the plain version's per-tile sums, far inside one bf16 ulp. Times: one
    decode layer's three projections at group 128 (187 MB routed: beyond
    the 50 MB L2); the bound counts the two routed experts' bytes. Each
    checked call must take the kernel route."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm

    def launched(what, *args):
        before = kernels.launch_counts()["moe_gather_int4"]
        got = mm.moe_gather_matmul_int4(*args)
        if kernels.launch_counts()["moe_gather_int4"] == before:
            raise AssertionError(f"moe_gather_int4 {what}: the call took another route")
        return got
    ids = torch.tensor([5, 2], device="cuda")
    xs = {k: torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    err, times = 0.0, {}
    for group in (128, 512):
        weights = {name: int4_experts(gen, MOE_E, k, n, group)
                   for name, (k, n) in MOE_SHAPES.items()}

        def call(fn, w, s):
            return fn(xs[2 * w.shape[1]], w, s, ids, 512, group)
        for name, (w, s) in weights.items():
            what = f"{name} group {group}"
            err = max(err, moe_compare(f"moe_gather_int4 {what}",
                                       launched(what, xs[2 * w.shape[1]], w, s, ids, 512, group),
                                       call(mm.moe_gather_matmul_int4_plain, w, s)))

        def layer(fn, weights=weights, call=call):
            return lambda: [call(fn, w, s) for w, s in weights.values()]
        times[group] = (median_ms(layer(mm.moe_gather_matmul_int4), reps=10),
                        median_ms(layer(mm.moe_gather_matmul_int4_plain), reps=2))
        if group == 128:
            gather_graph = graph_ms_or_none("moe_gather_int4", layer(mm.moe_gather_matmul_int4),
                                            reps=4)
        if group == 128:
            moved = sum(2 * nbytes(w[0], s[0]) + nbytes(xs[2 * w.shape[1]])
                        + 2 * 2 * w.shape[2] for w, s in weights.values())
            ops = sum(2 * 2 * 2 * w.shape[1] * w.shape[2] for w, _ in weights.values())
    for group in (128, 512):
        w, s = int4_experts(gen, MOE_E, 1024, 2048, group)
        x = torch.randn(16, 1024, generator=gen, device="cuda")
        sid = torch.randint(0, MOE_E, (16,), generator=gen, device="cuda")
        moe_compare(f"moe_gather_int4 f32 group {group}",
                    launched(f"f32 group {group}", x, w, s, sid, 512, group),
                    mm.moe_gather_matmul_int4_plain(x, w, s, sid, 512, group))
    return {"max_abs_err": err, "ms": times[128][0], "graph_ms": gather_graph,
            "plain_ms": times[128][1],
            "library_ms": None,  # no one PyTorch call gathers int4 experts and multiplies
            **bound(moved, ops, "bf16"),
            "shape": "one Mixtral decode layer: gate, up, down at S=2 slots (experts 5, 2), "
                     "packed int4 experts, group 128, bf16",
            "group512_ms_plain_ms": [round(t, 4) for t in times[512]]}


def seeded_groups(gen, tokens: int = 8, e: int = MOE_E, top_k: int = 2):
    """Group sizes of `tokens` tokens routed top-k over e experts by a
    random router (distinct experts per token), as the decoder sorts them."""
    import torch
    ids = torch.stack([torch.randperm(e, generator=gen, device="cuda")[:top_k]
                       for _ in range(tokens)]).flatten()
    return torch.bincount(ids, minlength=e)


def check_moe_grouped_int4(gen) -> dict:
    """#14 at Mixtral's expert shapes: 16 rows (8 tokens, top-2) sorted by
    expert over the experts a seeded routing gives, bf16, 16-row tiles, for
    group 128 and group 512; a ragged routing (experts with 1, 16 and 17
    rows: the last crosses a tile) on both routes; f32 activations (8-row
    tiles) at a smaller shape. Each call must take the kernel route. Held
    to the plain version of the whole grouped product with moe_compare
    (bf16: the split-K slices' f32 partials are added in slice order, one
    more f32 rounding per slice, far inside one bf16 ulp). Times: the
    kernel on the padded layout (scatter_layout's output, as the function
    hands it over) and its plain version there, for one layer's three
    projections, then the gate/up pair and the down projection apart (the
    long-k projection is where split-K acts); the whole function too, whose
    host work (the scatter's some 20 small tensor ops a call) takes longer
    than the kernel. Each bound counts the experts this routing uses."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm

    def launched(what, *args):
        before = kernels.launch_counts()["moe_grouped_int4"]
        got = mm.moe_grouped_matmul_int4(*args)
        if kernels.launch_counts()["moe_grouped_int4"] == before:
            raise AssertionError(f"moe_grouped_int4 {what}: the call took another route")
        return got
    gsz = seeded_groups(gen)
    m = int(gsz.sum())
    xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    padded = {k: mm.scatter_layout(x, gsz, 16, MOE_E) for k, x in xs.items()}
    ragged = torch.tensor([1, 0, 16, 0, 17, 0, 0, 0], device="cuda")
    xr = {k: torch.randn(int(ragged.sum()), k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    used = int((gsz > 0).sum())

    def moved(weights, names):
        return sum(used * nbytes(weights[p][0][0], weights[p][1][0])
                   + nbytes(xs[MOE_SHAPES[p][0]]) + 2 * m * MOE_SHAPES[p][1] for p in names)

    def ops(names):
        return sum(2 * m * k * n for k, n in (MOE_SHAPES[p] for p in names))
    err, out = 0.0, {}
    for group in (128, 512):
        weights = {name: int4_experts(gen, MOE_E, k, n, group)
                   for name, (k, n) in MOE_SHAPES.items()}
        for name, (w, s) in weights.items():
            for x, g, what in ((xs, gsz, "seeded"), (xr, ragged, "ragged 1/16/17")):
                k = 2 * w.shape[1]
                got = launched(f"{name} {what}", x[k], w, s, g, 512, group)
                err = max(err, moe_compare(f"moe_grouped_int4 {name} {what} group {group}", got,
                                           mm.moe_grouped_matmul_int4_plain(x[k], w, s, g, 512,
                                                                            group)))

        def on_padded(fn, names=tuple(MOE_SHAPES), weights=weights, group=group):
            def run():
                for p in names:
                    xp, _, texp, used_rows = padded[MOE_SHAPES[p][0]]
                    if fn is mm.grouped_int4_padded:
                        fn(xp, *weights[p], texp, used_rows, 512, group)
                    else:
                        fn(xp, *weights[p], texp, 512, group)
            return run
        res = {"ms": median_ms(on_padded(mm.grouped_int4_padded), reps=10),
               "graph_ms": graph_ms_or_none("moe_grouped_int4", on_padded(mm.grouped_int4_padded),
                                            reps=4),
               "plain_ms": median_ms(on_padded(mm.grouped_int4_padded_plain), reps=2),
               "function_ms": median_ms(lambda weights=weights, group=group: [
                   mm.moe_grouped_matmul_int4(xs[k], *weights[p], gsz, 512, group)
                   for p, (k, _) in MOE_SHAPES.items()], reps=5),
               **bound(moved(weights, MOE_SHAPES), ops(MOE_SHAPES), "bf16")}
        for names in (("gate", "up"), ("down",)):
            res["/".join(names)] = {
                "ms": median_ms(on_padded(mm.grouped_int4_padded, names), reps=10),
                **bound(moved(weights, names), ops(names), "bf16")}
        out[group] = res
        if group == 128:
            stacks = [(mm.dequant_int4_stack(w, s, 512, group, torch.bfloat16), None)
                      for w, s in weights.values()]
            library = grouped_mm_ms(xs, stacks, gsz)
            del stacks
    mp = padded[4096][0].shape[0]
    slices = {name: len(mm.grouped_int4_slices(k, 512, mm.grouped_int4_plan(
        mp, k, n, 512, sms))) for name, (k, n) in MOE_SHAPES.items()}
    log(f"  moe_grouped_int4 split-K slices ({mp} padded rows, {sms} SMs): {slices}")
    for group in (128, 512):
        w, s = int4_experts(gen, MOE_E, 1024, 2048, group)
        x = torch.randn(m, 1024, generator=gen, device="cuda")
        moe_compare(f"moe_grouped_int4 f32 group {group}",
                    launched(f"f32 group {group}", x, w, s, gsz, 512, group),
                    mm.moe_grouped_matmul_int4_plain(x, w, s, gsz, 512, group))
    return {"max_abs_err": err, **out[128],
            "library_ms": None,  # PyTorch has no packed-int4 grouped matmul
            "grouped_mm_bf16_ms": library,
            "shape": f"one Mixtral layer: gate, up, down over {m} rows sorted by expert "
                     f"({mp} padded), group sizes {gsz.tolist()}, packed int4 experts, "
                     f"group 128, bf16",
            "slices": slices, "group512": out[512]}


def check_fused_mlp_int4(gen) -> dict:
    """#6 at the Llama-3.1-8B MLP shape (h 4096, I 14336, group 128), m in
    {1, 8}, bf16, and with f32 activations (m = 3, h 512, I 1024), on random
    packed bytes and scales. Tolerance: one bf16 ulp of the largest output
    (both versions sum in f32 and round once at the same three places; a
    normalised input or act value may round the other way, far inside
    it); f32 1e-5 of it. Times at m = 1 (93.5 MB of packed weights and
    scales, beyond the 50 MB L2)."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm

    def weights(h, inter):
        out = []
        for k, n in ((h, inter), (h, inter), (inter, h)):
            w, s = int4_experts(gen, 1, k, n, 128)
            out += [w[0], s[0]]
        return out
    err = 0.0
    h, inter = 4096, 14336
    ws = weights(h, inter)
    nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    for m in (1, 8):
        x = torch.randn(m, h, generator=gen, device="cuda").to(torch.bfloat16)
        err = max(err, moe_compare(f"fused_mlp_int4 m={m}", qm.fused_mlp_int4(x, nw, *ws),
                                   qm.fused_mlp_int4_plain(x, nw, *ws)))
    small = weights(512, 1024)
    x3 = torch.randn(3, 512, generator=gen, device="cuda")
    nw3 = 1.0 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    moe_compare("fused_mlp_int4 f32", qm.fused_mlp_int4(x3, nw3, *small),
                qm.fused_mlp_int4_plain(x3, nw3, *small))
    x = torch.randn(1, h, generator=gen, device="cuda").to(torch.bfloat16)
    return {"max_abs_err": err,
            "ms": median_ms(lambda: qm.fused_mlp_int4(x, nw, *ws), reps=10),
            "graph_ms": graph_ms_or_none("fused_mlp_int4", lambda: qm.fused_mlp_int4(x, nw, *ws)),
            "plain_ms": median_ms(lambda: qm.fused_mlp_int4_plain(x, nw, *ws), reps=2),
            "library_ms": None,  # no one PyTorch call runs the fused int4 MLP
            **bound(nbytes(*ws, nw) + 2 * nbytes(x), 2 * 3 * h * inter, "bf16"),
            "shape": "Llama-3.1-8B MLP at m=1: h 4096, I 14336, group 128, bf16"}


# ---------------------------------------------------------------------------
# phase 4: the system
# ---------------------------------------------------------------------------

SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "si", "de", "pa",
             "gu", "hi", "zo", "be", "fa", "ti", "mo", "ly", "xa", "qe")


def write_corpus(data_dir: str, n_docs: int, seed: int) -> list:
    """n_docs short unique documents over a Zipf vocabulary, as CSV rows
    (one document per row). Returns the documents' texts."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vocab = sorted({"".join(rng.choice(SYLLABLES, rng.integers(2, 4)))
                    for _ in range(6000)})
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    texts = []
    for start in range(0, n_docs, 4096):
        with open(os.path.join(data_dir, f"notes_{start // 4096}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["title", "text"])
            for i in range(start, min(start + 4096, n_docs)):
                words = rng.choice(vocab, int(rng.integers(20, 40)), p=p)
                text = " ".join(words)
                w.writerow([f"note {i}", text])
                texts.append(text)
    return texts


def build_encoders(seed: int):
    from ragmeup_tpu_torch.models.cross_encoder import CrossEncoder
    from ragmeup_tpu_torch.models.encoder import BertConfig, SentenceEncoder
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    enc_cfg = BertConfig()                        # GIST-small shape
    encoder = SentenceEncoder(enc_cfg, SimpleTokenizer(enc_cfg.vocab_size),
                              seed=seed, device="cuda")
    ce_cfg = BertConfig(num_layers=6)             # MiniLM-L-6 shape
    cross = CrossEncoder(ce_cfg, SimpleTokenizer(ce_cfg.vocab_size),
                         seed=seed + 1, device="cuda")
    return encoder, cross


def build_llm(seed: int, cfg=None, **quant):
    """The Llama-3.1-8B-shaped decoder (int8 by default;
    ``quantization="int4"``, ``int4_w4a8``), or the decoder of ``cfg``
    (Mixtral-8x7B's), weights drawn and quantized on the card."""
    import torch
    from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM,
                                                  init_decoder_params)
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    t0 = time.perf_counter()
    llm_cfg = select_kernels(cfg or LlamaConfig.llama31_8b(**quant))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_decoder_params(llm_cfg, gen, "cuda")
    eos = (2,) if llm_cfg.num_experts else (128001, 128009)
    llm = LocalLLM(llm_cfg, SimpleTokenizer(llm_cfg.vocab_size), params=params,
                   eos_ids=eos, device="cuda")
    torch.cuda.synchronize()
    log(f"decoder {'Mixtral-8x7B-shaped ' if llm_cfg.num_experts else ''}"
        f"{llm_cfg.quantization}{' W4A8' if llm_cfg.int4_w4a8 else ''} "
        f"built on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    if llm_cfg.num_experts:
        cos, flips, note = check_moe_decoder(llm)
        log(f"  decode step vs prefill logits cosine {cos:.5f}; the last token's "
            f"experts differ in {len(flips)} of {llm_cfg.num_layers} layers {flips}"
            + (f"; {note}" if note else ""))
    else:
        cos = check_decoder(llm)
        log(f"  decode step vs prefill logits cosine {cos:.5f}")
    return llm


def check_decoder(llm) -> float:
    """Decode against prefill: the logits of one decode step (m = 1 matmul
    kernels, einsum attention over the cache) must match a prefill of the
    same tokens (flash kernel; int8: dequantized matmuls, int4: the kernels
    at m = 256) up to bf16 noise: cosine >= 0.99. W4A8 rounds every
    activation row to int8, and one bf16 ulp of an activation near its
    row's largest is half a code step, so the two paths round many codes
    apart and compound that over 32 layers: its bound is 0.95."""
    import torch
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(4, 30000, (200,), generator=gen).tolist()
    with torch.inference_mode():
        n = len(ids) - 1
        cache_len = llm._bucket(len(ids))
        _, caches = llm._prefill(llm._padded(ids[:n], llm._bucket(n)), n, cache_len)
        step = llm._decode(ids[n], n, caches).float()
        full, _ = llm._prefill(llm._padded(ids, cache_len), len(ids), cache_len)
        full = full.float()
    if not (torch.isfinite(step).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite decoder logits")
    cos = torch.nn.functional.cosine_similarity(step, full, dim=0).item()
    if cos < (0.95 if llm.cfg.int4_w4a8 else 0.99):
        raise AssertionError(f"decode/prefill logits disagree: cosine {cos}")
    return cos


def check_moe_decoder(llm):
    """check_decoder for the MoE decoder. The decode step runs #10 (each
    expert product summed in f32, scaled, rounded once), the prefill the
    bf16 einsum over experts dequantized to bf16, so a near-tie in a router
    can send the last token to another expert in the two paths, which is no
    kernel error; from there on the two hidden states differ by a whole
    expert's output and later layers route apart too. The last token's
    routed experts are compared layer by layer. Where they agree in every
    layer, the logits must agree to cosine >= 0.99, W4A8 too: no W4A8 run
    without a flip has been read yet. int4 experts: decode gathers through #13 (each weight
    f32(q) * f32(s) rounded to bf16), prefill dequantizes the stacks in bf16
    (bf16(q) * bf16(s)), so near-ties flip the same way. At the first layer that
    routes apart, the flip must be a near-tie: the top_k-th router logit
    leads the next by at most twice the largest difference between the two
    paths' router logits there. Returns (cosine, flipped layers, a note on
    the first flip)."""
    import torch
    from ragmeup_tpu_torch.models.decoder import LlamaMoeMlp
    seen = []

    def hook(mod, args, out):
        x = args[0].reshape(-1, args[0].shape[-1])
        seen.append((x.float(), x.float() @ mod.router.float(), mod.route(x)[1]))
    handles = [layer.mlp.register_forward_hook(hook) for layer in llm.model.layers
               if isinstance(layer.mlp, LlamaMoeMlp)]
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(4, 30000, (200,), generator=gen).tolist()
    n = len(ids) - 1
    try:
        with torch.inference_mode():
            cache_len = llm._bucket(len(ids))
            _, caches = llm._prefill(llm._padded(ids[:n], llm._bucket(n)), n, cache_len)
            seen.clear()
            step = llm._decode(ids[n], n, caches).float()
            at_step = [(x[0], lg[0], i[0]) for x, lg, i in seen]
            seen.clear()
            full, _ = llm._prefill(llm._padded(ids, cache_len), len(ids), cache_len)
            full = full.float()
            at_full = [(x[n], lg[n], i[n]) for x, lg, i in seen]
    finally:
        for h in handles:
            h.remove()
    if not (torch.isfinite(step).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite decoder logits")
    if len(at_step) != len(handles) or len(at_full) != len(handles):
        raise AssertionError("an MoE layer was not run")
    flips = [i for i, (a, b) in enumerate(zip(at_step, at_full))
             if not torch.equal(a[2].sort().values, b[2].sort().values)]
    cos = torch.nn.functional.cosine_similarity(step, full, dim=0).item()
    if not flips:
        if cos < 0.99:
            raise AssertionError(f"decode/prefill logits disagree with the same routing: "
                                 f"cosine {cos}")
        return cos, flips, ""
    f = flips[0]
    (xs, ls, _), (xf, lf, _) = at_step[f], at_full[f]
    k = llm.cfg.num_experts_per_tok
    margin = min((lg.sort(descending=True).values[k - 1]
                  - lg.sort(descending=True).values[k]).item() for lg in (ls, lf))
    diff = (ls - lf).abs().max().item()
    drift = ((xs - xf).norm() / xf.norm()).item()
    note = (f"first flip at layer {f}: router-logit margin {margin:.5f}, the paths' "
            f"router logits differ by up to {diff:.5f}, its input by {drift:.5f} "
            f"(relative norm)")
    if margin > 2 * diff:
        raise AssertionError(f"the last token routes apart at layer {f} without a "
                             f"near-tie: {note}")
    return cos, flips, note


def time_llm_calls(llm) -> list:
    """Wrap ``llm.generate`` so that each call appends (prompt tokens, new
    tokens, ms) to the returned list, timed on the host around a
    synchronised call."""
    import torch
    calls = []
    generate = llm.generate

    def timed(prompt_ids, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(prompt_ids, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append((len(prompt_ids), len(out), (time.perf_counter() - t0) * 1e3))
        return out
    llm.generate = timed
    return calls


# the kernels each run of requests must launch
PATH_KERNELS = {"default": ("topk", "int8_matmul", "flash_gqa"),
                "int4 W4A16": ("topk_int8", "int4_matmul", "flash_gqa"),
                "int4 W4A8": ("topk_int8", "int4_matmul_a8", "flash_gqa"),
                "batched": ("topk", "int8_matmul", "paged_attention",
                            "paged_attention_chunk"),
                "moe": ("topk", "int8_matmul", "flash_gqa", "moe_gather"),
                "moe grouped": ("moe_grouped_stack", "moe_gather"),
                "moe batched": ("paged_attention", "paged_attention_chunk",
                                "moe_grouped"),
                "moe int4": ("topk", "int4_matmul", "flash_gqa", "moe_gather_int4"),
                "moe int4 batched": ("paged_attention", "paged_attention_chunk",
                                     "moe_grouped_int4"),
                "moe int4 W4A8": ("topk", "int4_matmul_a8", "moe_gather_int4")}


def rag_config(data_dir: str, index_dir: str, **model):
    from ragmeup_tpu_torch import RagConfig
    cfg = RagConfig()
    cfg.data.data_directory = data_dir
    cfg.data.index_directory = index_dir
    cfg.generation.max_new_tokens = MAX_NEW_TOKENS
    if model:
        cfg.retrieval.dense_dtype = "int8"
        for key, value in model.items():
            setattr(cfg.model, key, value)
    return cfg


def open_system(cfg, encoder, cross, llm):
    """RagSystem on the card: ingest + embed + index, or the saved artifact;
    a stored vector must then find itself first."""
    import torch
    from ragmeup_tpu_torch.pipeline.system import RagSystem
    t0 = time.perf_counter()
    system = RagSystem(cfg, encoder=encoder, cross_encoder=cross, llm=llm,
                       device="cuda")
    torch.cuda.synchronize()
    log(f"RagSystem ({system.dense.dtype} index): {system.dense.n} chunks, "
        f"capacity {system.dense.capacity}, {time.perf_counter() - t0:.1f} s")
    if system.dense.n != N_DOCS:
        raise AssertionError(f"{system.dense.n} chunks for {N_DOCS} docs")
    rows = [0, 4242, N_DOCS - 1]
    hits = system.dense.search(system.dense.gather_rows(rows), 1)
    if [h[0][0] for h in hits] != rows:
        raise AssertionError(f"self-retrieval failed: {hits}")
    return system


def drive(label: str, system, llm, queries) -> dict:
    """chat() requests (the third sends the second's history), with the
    launch counts reset just before and read just after; checks each reply
    and that every kernel of the path launched."""
    import torch
    from ragmeup_tpu_torch import kernels
    llm_calls = time_llm_calls(llm)
    kernels.reset_counts()
    latencies, outs, history = [], [], []
    for i, q in enumerate(queries):
        first_call = len(llm_calls)
        t0 = time.perf_counter()
        out = system.chat(q, history if i == 2 else None)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        outs.append(out)
        if i == 1:
            history = out["history"]
        log(f"{label} request {i + 1}: {latencies[-1] * 1e3:.1f} ms, "
            f"fetched={out['fetched_new_documents']} "
            f"rewritten={out['rewritten']} docs={len(out['documents'])} "
            f"reply={out['reply'][:60]!r} timings="
            + json.dumps({k: round(v, 1) for k, v in out["timings"].items()}))
        log(f"  LLM calls (prompt tokens, new tokens, ms): "
            f"{[(p, n, round(ms, 1)) for p, n, ms in llm_calls[first_call:]]}")
    counts = kernels.launch_counts()
    log(f"{label}: launch counts over its {len(queries)} requests: {counts}")

    for i, out in enumerate(outs):
        check_reply(label, i, out, first_turn=i != 2)
    missing = [k for k in PATH_KERNELS[label] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    return {"counts": counts, "latency_s": latencies}


def check_reply(label: str, i: int, out: dict, first_turn: bool) -> None:
    """A reply is non-empty; a fetch brings valid documents; a first turn
    must fetch, and a follow-up that does not fetch carries no documents."""
    if not out["reply"]:
        raise AssertionError(f"{label} request {i + 1}: empty reply")
    if out["fetched_new_documents"]:
        docs = out["documents"]
        if not docs:
            raise AssertionError(f"{label} request {i + 1}: no documents")
        for d in docs:
            if not 0 <= d["pk"] < N_DOCS or not math.isfinite(d["provenance"]):
                raise AssertionError(f"{label} request {i + 1}: bad document {d}")
    elif first_turn:
        raise AssertionError(f"{label} request {i + 1}: a first turn must fetch")
    elif out["documents"]:
        raise AssertionError(f"{label} request {i + 1}: documents without a fetch")


def drive_batched(system, queries, label: str = "batched") -> dict:
    """Phase 6: the first turns at once, one thread each, then a follow-up
    with the first one's history, through the paged serving engine. Launch
    counts are reset just before and read just after. The engine's wave
    batch must have reached the next power of two above the number of
    first turns (pad rows included, as the engine runs it)."""
    import torch
    from ragmeup_tpu_torch import kernels
    backend = system.backend
    engine = backend.engine
    engine.wave_timings = []
    n = len(queries)
    outs, latencies = [None] * n, [0.0] * n
    errors = []

    def one(i):
        try:
            t0 = time.perf_counter()
            outs[i] = system.chat(queries[i])
            latencies[i] = time.perf_counter() - t0
        except Exception as exc:  # re-raised below, in the main thread
            errors.append(exc)

    kernels.reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    follow = system.chat("Tell me more about that.", outs[0]["history"])
    torch.cuda.synchronize()
    latencies.append(time.perf_counter() - t1)
    counts = kernels.launch_counts()
    outs.append(follow)
    for i, out in enumerate(outs):
        log(f"{label} request {i + 1}: {latencies[i] * 1e3:.1f} ms, "
            f"fetched={out['fetched_new_documents']} rewritten={out['rewritten']} "
            f"docs={len(out['documents'])} reply={out['reply'][:60]!r} timings="
            + json.dumps({k: round(v, 1) for k, v in out["timings"].items()}))
        check_reply(label, i, out, first_turn=i < n)
    stats = backend.latency_stats()
    waves = engine.wave_timings
    summary = {key: {"n": len(vals), "median_ms": round(statistics.median(vals) * 1e3, 3),
                     "max_ms": round(max(vals) * 1e3, 3)}
               for key in ("prep", "dispatch", "fetch")
               for vals in [[w[key] for w in waves if key in w]] if vals}
    cache = engine.cache
    log(f"{label}: {n} concurrent first turns in {wall:.2f} s, follow-up "
        f"{latencies[-1]:.2f} s; LLM calls {stats}")
    log(f"{label}: wave timings {json.dumps(summary)}; prefix hits "
        f"{cache.prefix_hits} of {cache.prefix_lookups} lookups; wave batch "
        f"reached {engine._B_hwm} rows")
    log(f"{label}: launch counts over its {n + 1} requests: {counts}")
    if engine._B_hwm < 1 << (n - 1).bit_length():
        raise AssertionError(f"{label}: the wave batch reached {engine._B_hwm} rows, "
                             f"not {1 << (n - 1).bit_length()}: the first turns did not "
                             f"overlap")
    missing = [k for k in PATH_KERNELS[label] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    if cache.prefix_hits <= 0:
        raise AssertionError(f"{label}: no prefix-cache hit over the phase")
    backend.stop()
    if backend._worker.is_alive():
        raise AssertionError(f"{label}: the serving worker did not stop")
    held = {p for pages in cache.seq_pages.values() for p in pages}
    if held != {engine._trash} or any(cache.refs[p] for p in cache.page_digest) \
            or len(cache._free) + len(cache.page_digest) != cache.num_pages - 1:
        raise AssertionError(f"{label}: pages leaked after stop: {len(cache._free)} "
                             f"free, {len(cache.page_digest)} registered")
    return {"counts": counts, "latency_s": latencies, "llm_calls": stats,
            "waves": summary, "prefix_hits": cache.prefix_hits, "rows": engine._B_hwm}


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_system(seed: int) -> dict:
    """The ten runs of requests; returns each run's counts and latencies."""
    import torch
    encoder, cross = build_encoders(seed)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        texts = write_corpus(data_dir, N_DOCS, seed)
        words = texts[7].split()
        queries = [f"What do the notes say about {' '.join(words[:3])}?",
                   f"Which notes mention {' '.join(texts[4242].split()[:2])}?",
                   "Tell me more about that."]

        llm = build_llm(seed)
        system = open_system(rag_config(data_dir, os.path.join(tmp, "index")),
                             encoder, cross, llm)
        runs["default"] = drive("default", system, llm, queries)
        cfg = rag_config(data_dir, os.path.join(tmp, "index"))
        cfg.server.batched_llm = True
        batched = open_system(cfg, encoder, cross, llm)
        runs["batched"] = drive_batched(batched, queries[:2] + [
            f"What is {' '.join(texts[99].split()[:2])}?",
            f"Summarize the notes on {' '.join(texts[12000].split()[:3])}."])
        del system, batched, llm
        free_card()

        index_q = os.path.join(tmp, "index_int8")
        llm = build_llm(seed, quantization="int4")
        system = open_system(rag_config(data_dir, index_q, quantization="int4"),
                             encoder, cross, llm)
        runs["int4 W4A16"] = drive("int4 W4A16", system, llm, queries)
        codes = system.dense._corpus_t[:, :N_DOCS].clone()
        scales = system.dense._scales[:, :N_DOCS].clone()
        del system, llm
        free_card()

        llm = build_llm(seed, quantization="int4", int4_w4a8=True)
        system = open_system(rag_config(data_dir, index_q, quantization="int4",
                                        int4_w4a8=True), encoder, cross, llm)
        if not (torch.equal(system.dense._corpus_t[:, :N_DOCS], codes)
                and torch.equal(system.dense._scales[:, :N_DOCS], scales)):
            raise AssertionError("the reloaded int8 artifact changed the codes")
        runs["int4 W4A8"] = drive("int4 W4A8", system, llm, queries[1:2])
        del system, llm
        free_card()

        for phase in (run_moe, run_moe_int4):
            runs.update(phase(seed, encoder, cross, data_dir, os.path.join(tmp, "index"),
                              texts, queries))
    return runs


def eight_first_turns(texts, queries) -> list:
    """The batched MoE runs' eight concurrent first turns."""
    return queries[:2] + [
        f"What is {' '.join(texts[i].split()[:2])}?" for i in (99, 555, 2024, 7777)] + [
        f"Summarize the notes on {' '.join(texts[i].split()[:3])}."
        for i in (12000, 15000)]


def run_moe(seed: int, encoder, cross, data_dir: str, index_dir: str, texts,
            queries) -> dict:
    """Phase 7 on the Mixtral-8x7B-shaped int8 decoder (47.5 GB), with the
    bf16 index of phase 4: three requests on the default config; one on a
    second decoder over the same weights (shared storage) with
    moe_grouped="on"; eight first turns at once through the paged engine,
    then a follow-up."""
    import dataclasses
    from ragmeup_tpu_torch.models.decoder import LlamaConfig, LocalLLM
    runs = {}
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b())
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, llm)
    runs["moe"] = drive("moe", system, llm, queries)
    grouped = LocalLLM(dataclasses.replace(llm.cfg, moe_grouped="on"), llm.tokenizer,
                       params=llm.model.state_dict(), eos_ids=llm.eos_ids, device="cuda")
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, grouped)
    runs["moe grouped"] = drive("moe grouped", system, grouped, queries[:1])
    del system, grouped
    free_card()
    cfg = rag_config(data_dir, index_dir)
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, llm)
    runs["moe batched"] = drive_batched(batched, eight_first_turns(texts, queries),
                                        label="moe batched")
    del batched, llm
    free_card()
    return runs


def run_moe_int4(seed: int, encoder, cross, data_dir: str, index_dir: str, texts,
                 queries) -> dict:
    """Phase 8 on the Mixtral-8x7B-shaped decoder with packed int4 experts
    (group 128; about 25 GB), with the bf16 index of phase 4: three
    requests on the default config ("moe int4": decode through #13); the
    paged engine on the same decoder with eight first turns at once and a
    follow-up ("moe int4 batched": 8-row waves through #14); then a W4A8
    decoder (512-row groups: #5 and the output-scaled route of #13) answers
    one ("moe int4 W4A8")."""
    from ragmeup_tpu_torch.models.decoder import LlamaConfig
    runs = {}
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b(quantization="int4"))
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, llm)
    runs["moe int4"] = drive("moe int4", system, llm, queries)
    del system
    cfg = rag_config(data_dir, index_dir)
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, llm)
    runs["moe int4 batched"] = drive_batched(batched, eight_first_turns(texts, queries),
                                             label="moe int4 batched")
    del batched, llm
    free_card()
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b(quantization="int4", int4_w4a8=True))
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, llm)
    runs["moe int4 W4A8"] = drive("moe int4 W4A8", system, llm, queries[1:2])
    del system, llm
    free_card()
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU only")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ragmeup_tpu_torch import kernels
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    log_ptxas(kernels.build_log)

    clock_before = clocks()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {  # N_DOCS rows fill the dense index's capacity exactly
        "topk": (stamped(check_topk(gen, N_DOCS)), "ragmeup_tpu_torch/csrc/topk.cu",
                 "ragmeup_tpu/ops/topk.py:63"),
        "int8_matmul": (stamped(check_int8_matmul(gen)),
                        "ragmeup_tpu_torch/csrc/quant_matmul.cu",
                        "ragmeup_tpu/ops/quant_matmul.py:27"),
        "flash_gqa": (stamped(check_flash(gen)),
                      "ragmeup_tpu_torch/csrc/flash_attention.cu",
                      "ragmeup_tpu/ops/attention.py:156"),
        "topk_int8": (stamped(check_topk_int8(gen, N_DOCS)),
                      "ragmeup_tpu_torch/csrc/topk.cu", "ragmeup_tpu/ops/topk.py:88"),
        "int4_matmul": (stamped(check_int4(gen, a8=False)),
                        "ragmeup_tpu_torch/csrc/quant_matmul_int4.cu",
                        "ragmeup_tpu/ops/quant_matmul.py:174"),
        "int4_matmul_a8": (stamped(check_int4(gen, a8=True)),
                           "ragmeup_tpu_torch/csrc/quant_matmul_int4.cu",
                           "ragmeup_tpu/ops/quant_matmul.py:257"),
    }
    paged = {mode: stamped(r) for mode, r in check_paged(gen).items()}
    for name, mode in (("paged_attention", "decode"), ("paged_attention_chunk", "chunk")):
        results[name] = (paged[mode], "ragmeup_tpu_torch/csrc/paged_attention.cu",
                         "ragmeup_tpu/ops/paged_attention.py:487")
    free_card()
    results["moe_gather"] = (stamped(check_moe_gather(gen)),
                             "ragmeup_tpu_torch/csrc/moe_matmul.cu",
                             "ragmeup_tpu/ops/moe_matmul.py:47")
    free_card()
    grouped = {name: stamped(r) for name, r in check_moe_grouped(gen).items()}
    for name, rep in (("moe_grouped", 123), ("moe_grouped_stack", 220)):
        results[name] = (grouped[name], "ragmeup_tpu_torch/csrc/moe_matmul.cu",
                         f"ragmeup_tpu/ops/moe_matmul.py:{rep}")
    free_card()
    results["moe_gather_int4"] = (stamped(check_moe_gather_int4(gen)),
                                  "ragmeup_tpu_torch/csrc/quant_matmul_int4.cu",
                                  "ragmeup_tpu/ops/moe_matmul.py:483")
    free_card()
    results["moe_grouped_int4"] = (stamped(check_moe_grouped_int4(gen)),
                                   "ragmeup_tpu_torch/csrc/moe_matmul_int4.cu",
                                   "ragmeup_tpu/ops/moe_matmul.py:611")
    free_card()
    # no path runs #6 (as in the JAX package): its launches stay 0
    results["fused_mlp_int4"] = (stamped(check_fused_mlp_int4(gen)),
                                 "ragmeup_tpu_torch/csrc/fused_mlp_int4.cu",
                                 "ragmeup_tpu/ops/quant_matmul.py:414")
    clock_after = clocks()
    for name, (r, _, _) in results.items():
        log(f"kernel {name}: {json.dumps(r)}")
    free_card()

    runs = run_system(args.seed)
    for label, run in runs.items():
        log(f"{label}: /chat latency per request (s): "
            f"{[round(x, 3) for x in run['latency_s']]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(run["counts"][name] for run in runs.values()),
         **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}}
        for name, (r, src, rep) in results.items()],
        "clocks_sm_mem": {"before_kernel_checks": clock_before,
                          "after_kernel_checks": clock_after}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
