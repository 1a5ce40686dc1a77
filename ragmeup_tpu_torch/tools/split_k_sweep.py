"""The split plans' targets against their neighbours, on one card.

    python3 -m ragmeup_tpu_torch.tools.split_k_sweep

Each plan aims at a number of blocks an SM (a module constant); each
target is timed in turn with the split counts it gives:

- #14 (csrc/moe_matmul_int4.cu, ``grouped_int4_plan``,
  ``_INT4_BLOCKS_PER_SM``) on the padded layout at Mixtral-8x7B's
  batched-decode shapes: 16 rows (8 tokens routed top-2 over 8 experts by
  a seeded random router) against packed int4 experts of groups 128 and
  512, the gate/up pair (k 4096, n 14336) and the down projection (k
  14336, n 4096) apart; CUDA events around an eager loop (the kernel takes
  longer than its host call).
- #3 (csrc/quant_matmul.cu, ``int8_matmul_plan``, ``_INT8_BLOCKS_PER_SM``)
  over the 7 projections of one Llama-3.1-8B decode layer at m = 1 and 8;
- #9 (csrc/paged_attention.cu, ``paged_split_plan``,
  ``_DECODE_BLOCKS_PER_SM`` and ``_CHUNK_BLOCKS_PER_SM``) at the 8B serving
  shapes: decode at 8, 4 and 1 sequences, the 128-token chunk at 4 and 1;
  #3 and #9 from a CUDA graph's replay, since their wrappers' host cost
  exceeds their device time.

Medians of five rounds after warm-up. Prints the card's name and power
limit, then one JSON line per kernel.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import moe_matmul as mm
from ragmeup_tpu_torch.ops import paged_attention as pa
from ragmeup_tpu_torch.ops import quant_matmul as qm

SHAPES = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
TARGETS = (1, 2, 4, 8, 16)
LLAMA_8B = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024), "o": (4096, 4096),
            "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}


def _ms(fn, reps: int = 10, rounds: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _graph_ms(fn, reps: int = 10) -> float:
    """One call's device time: `reps` calls captured in a CUDA graph,
    the replay timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return _ms(graph.replay, reps=1) / reps


def sweep_grouped_int4(gen, sms: int) -> dict:
    ids = torch.stack([torch.randperm(8, generator=gen, device="cuda")[:2]
                       for _ in range(8)]).flatten()
    gsz = torch.bincount(ids, minlength=8)
    padded = {k: mm.scatter_layout(torch.randn(16, k, generator=gen, device="cuda")
                                   .to(torch.bfloat16), gsz, 16, 8) for k in (4096, 14336)}
    default = mm._INT4_BLOCKS_PER_SM
    out = {"kernel": "moe_grouped_int4", "group_sizes": gsz.tolist(), "default_target": default}
    try:
        for group in (128, 512):
            weights = {p: (torch.randint(-128, 128, (8, k // 2, n), generator=gen,
                                         device="cuda", dtype=torch.int8),
                           torch.rand(8, k // group, n, generator=gen, device="cuda") * 2e-3
                           + 1e-3) for p, (k, n) in SHAPES.items()}
            for target in TARGETS:
                mm._INT4_BLOCKS_PER_SM = target
                row = {}
                for names in (("gate", "up"), ("down",)):
                    def run(names=names):
                        for p in names:
                            xp, _, texp, used = padded[SHAPES[p][0]]
                            mm.grouped_int4_padded(xp, *weights[p], texp, used, 512, group)
                    k, n = SHAPES[names[0]]
                    slices = len(mm.grouped_int4_slices(k, 512, mm.grouped_int4_plan(
                        padded[k][0].shape[0], k, n, 512, sms)))
                    row["/".join(names)] = {"ms": _ms(run), "slices": slices}
                out[f"group{group} target{target}"] = row
    finally:
        mm._INT4_BLOCKS_PER_SM = default
    return out


def sweep_int8(gen, sms: int) -> dict:
    weights = [(torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand(n, generator=gen, device="cuda") * 2e-4 + 1e-4)
               for k, n in LLAMA_8B.values()]
    xs = {m: {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)} for m in (1, 8)}
    default = qm._INT8_BLOCKS_PER_SM
    out = {"kernel": "int8_matmul", "default_target": default}
    try:
        for target in (1, 2, 3, 4, 8):
            qm._INT8_BLOCKS_PER_SM = target
            out[f"target{target}"] = {
                f"m{m}_layer_graph_ms": _graph_ms(lambda m=m: [
                    qm.int8_matmul(xs[m][w.shape[0]], w, s) for w, s in weights], reps=4)
                for m in (1, 8)}
            out[f"target{target}"]["slices_m1"] = {
                name: len(qm.int8_slices(k, qm.int8_matmul_plan(1, k, n, sms)))
                for name, (k, n) in LLAMA_8B.items()}
    finally:
        qm._INT8_BLOCKS_PER_SM = default
    return out


def sweep_paged(gen, sms: int) -> dict:
    def pool(b, lengths, q_len):
        q = torch.randn(b, q_len, 32, 128, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(8, 512, 128, 128, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        idx = torch.randperm(512, generator=gen, device="cuda")[:b * 16].reshape(b, 16)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        return (q[:, 0].contiguous() if q_len == 1 else q), k, v, idx.to(torch.int32), lens
    cases = {"decode b=8": (8, [1, 2048, 777, 128, 129, 1500, 64, 1024], 1),
             "decode b=4": (4, [1024, 1333, 1700, 2048], 1), "decode b=1": (1, [2048], 1),
             "chunk b=4": (4, [128, 768, 1461, 2048], 128), "chunk b=1": (1, [2048], 128)}
    inputs = {label: pool(*case) for label, case in cases.items()}
    default = (pa._DECODE_BLOCKS_PER_SM, pa._CHUNK_BLOCKS_PER_SM)
    out = {"kernel": "paged_attention", "default_targets": default}
    try:
        for target in TARGETS:
            pa._DECODE_BLOCKS_PER_SM = pa._CHUNK_BLOCKS_PER_SM = target
            row = {}
            for label, (q, k, v, idx, lens) in inputs.items():
                fn = pa.paged_attention if label.startswith("decode") else pa.paged_attention_chunk
                b, q_len = cases[label][0], cases[label][2]
                row[label] = {
                    "graph_ms": _graph_ms(lambda fn=fn, q=q, k=k, v=v, idx=idx, lens=lens:
                                          fn(q, k, v, idx, lens)),
                    "splits": pa.paged_splits(16, 128, pa.kernel_split(
                        b, q_len, 32, 8, 128, 16, torch.bfloat16, sms))}
            out[f"target{target}"] = row
    finally:
        pa._DECODE_BLOCKS_PER_SM, pa._CHUNK_BLOCKS_PER_SM = default
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("split_k_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = kernels.sm_count(0)
    for sweep in (sweep_grouped_int4, sweep_int8, sweep_paged):
        print(json.dumps(sweep(gen, sms)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
