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
- #4's decode kernel (csrc/quant_matmul_int4.cu, ``int4_decode_plan``,
  ``quant_matmul._INT4_BLOCKS_PER_SM``) over the same layer packed in int4
  with 128-row scale groups, at m = 1 and 8, 1 to 4 blocks an SM;
- #5's decode kernel (csrc/quant_matmul_int4.cu ``rk_int4_a8_decode_kernel``,
  ``int4_a8_decode_plan``, ``quant_matmul._INT4_A8_BLOCKS_PER_SM``) over
  the same layer in W4A8 (512-row tiles, one scale each), at m = 1 and 8, 1
  to 8 blocks an SM;
- #13, the int4 expert gather on the same decode kernels
  (``moe_matmul.int4_gather_plan``, the same constant), over one
  Mixtral-8x7B decode layer's gate, up and down at 2 slots (experts 5 and
  2 of 8), groups 128 and 512, 1 to 4 blocks an SM;
- #10 on bf16 rows (csrc/moe_matmul.cu ``rk_moe_gather_stream_kernel``,
  ``moe_matmul.gather_plan``, ``_GATHER_BLOCKS_PER_SM``) over one
  Mixtral-8x7B decode layer at 2 slots (experts 5 and 2) and one
  Qwen3-30B-A3B layer (E 128, 2048 x 768 and 768 x 2048) at 8 slots, 1, 2,
  3, 4, 6 and 8 blocks an SM;
- #11's grouped-rows kernel (csrc/moe_matmul.cu
  ``rk_moe_grouped_mma_kernel``, ``moe_matmul.grouped_rows_plan``,
  ``_GROUPED_BLOCKS_PER_SM``) over one Mixtral-8x7B layer on the dedup
  route at 16 rows (groups 3, 2, 0, 4, 1, 2, 3, 1), gate/up and down apart,
  1 to 16 blocks an SM;
- #9 (csrc/paged_attention.cu, ``paged_split_plan``,
  ``_DECODE_BLOCKS_PER_SM`` and ``_CHUNK_BLOCKS_PER_SM``) at the 8B serving
  shapes: decode at 8, 4 and 1 sequences, the 128-token chunk at 4 and 1;
  #3, #4, #5, #13, #10, #11 and #9 from a CUDA graph's replay, since
  their wrappers' host cost exceeds their device time.

Medians of five rounds after warm-up. Prints the card's name and power
limit, then one JSON line per kernel. Arguments name the sweeps to run
(``gather``, ``grouped_rows``, ``grouped_int4``, ``int8``, ``int4_decode``,
``int4_a8``, ``gather_int4``, ``paged``); none runs them all.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

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


def sweep_int4_decode(gen, sms: int) -> dict:
    weights = [(torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand(k // 128, n, generator=gen, device="cuda") * 2e-3 + 1e-3)
               for k, n in LLAMA_8B.values()]
    xs = {m: {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)} for m in (1, 8)}
    default = qm._INT4_BLOCKS_PER_SM
    out = {"kernel": "int4_matmul (decode)", "default_target": default}
    try:
        for target in (1, 2, 3, 4):
            qm._INT4_BLOCKS_PER_SM = target
            out[f"target{target}"] = {
                f"m{m}_layer_graph_ms": _graph_ms(lambda m=m: [
                    qm.int4_matmul(xs[m][2 * w.shape[0]], w, s) for w, s in weights], reps=4)
                for m in (1, 8)}
            out[f"target{target}"]["slices_m1"] = {
                name: len(qm.int4_decode_slices(k, 512, qm.int4_decode_plan(
                    1, k, n, 512, 128, sms))) for name, (k, n) in LLAMA_8B.items()}
    finally:
        qm._INT4_BLOCKS_PER_SM = default
    return out


def sweep_int4_a8(gen, sms: int) -> dict:
    weights = [(torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand(k // 512, n, generator=gen, device="cuda") * 2e-3 + 1e-3)
               for k, n in LLAMA_8B.values()]
    xs = {m: {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)} for m in (1, 8)}
    default = qm._INT4_A8_BLOCKS_PER_SM
    out = {"kernel": "int4_matmul_a8 (decode)", "default_target": default}
    try:
        for target in range(1, 9):
            qm._INT4_A8_BLOCKS_PER_SM = target
            out[f"target{target}"] = {
                f"m{m}_layer_graph_ms": _graph_ms(lambda m=m: [
                    qm.int4_matmul(xs[m][2 * w.shape[0]], w, s, a8=True) for w, s in weights],
                    reps=4)
                for m in (1, 8)}
            out[f"target{target}"]["slices"] = {
                name: len(qm.int4_decode_slices(k, 512, qm.int4_a8_decode_plan(
                    1, k, n, 512, sms))) for name, (k, n) in LLAMA_8B.items()}
    finally:
        qm._INT4_A8_BLOCKS_PER_SM = default
    return out


def sweep_gather_int4(gen, sms: int) -> dict:
    ids = torch.tensor([5, 2], device="cuda")
    xs = {k: torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    default = qm._INT4_BLOCKS_PER_SM
    out = {"kernel": "moe_gather_int4", "default_target": default}
    try:
        for group in (128, 512):
            weights = [(torch.randint(-128, 128, (8, k // 2, n), generator=gen, device="cuda",
                                      dtype=torch.int8),
                        torch.rand(8, k // group, n, generator=gen, device="cuda") * 2e-3
                        + 1e-3) for k, n in SHAPES.values()]
            for target in (1, 2, 3, 4):
                qm._INT4_BLOCKS_PER_SM = target
                out[f"group{group} target{target}"] = {
                    "layer_graph_ms": _graph_ms(lambda: [
                        mm.moe_gather_matmul_int4(xs[2 * w.shape[1]], w, s, ids, 512, group)
                        for w, s in weights], reps=4),
                    "slices": {name: len(qm.int4_decode_slices(k, 512, mm.int4_gather_plan(
                        2, k, n, 512, group, sms))) for name, (k, n) in SHAPES.items()}}
            del weights
    finally:
        qm._INT4_BLOCKS_PER_SM = default
    return out


def _int8_experts(gen, e: int, shapes: dict) -> list:
    return [(torch.randint(-127, 128, (e, k, n), generator=gen, device="cuda",
                           dtype=torch.int8),
             torch.rand(e, n, generator=gen, device="cuda") * 2e-4 + 1e-4)
            for k, n in shapes.values()]


def sweep_gather(gen, sms: int) -> dict:
    qwen = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
    cases = {"mixtral s2": (_int8_experts(gen, 8, SHAPES), torch.tensor([5, 2], device="cuda")),
             "qwen3 s8": (_int8_experts(gen, 128, qwen),
                          torch.randperm(128, generator=gen, device="cuda")[:8])}
    xs = {(k, len(ids)): torch.randn(len(ids), k, generator=gen, device="cuda")
          .to(torch.bfloat16) for ws, ids in cases.values() for w, _ in ws
          for k in (w.shape[1],)}
    default = mm._GATHER_BLOCKS_PER_SM
    out = {"kernel": "moe_gather", "default_target": default}
    try:
        for target in (1, 2, 3, 4, 6, 8):
            mm._GATHER_BLOCKS_PER_SM = target
            row = {}
            for label, (ws, ids) in cases.items():
                row[label] = {
                    "layer_graph_ms": _graph_ms(lambda ws=ws, ids=ids: [
                        mm.moe_gather_matmul(xs[w.shape[1], len(ids)], w, ids, s)
                        for w, s in ws], reps=4),
                    "slices": [len(mm.gather_slices(w.shape[1], mm.gather_plan(
                        len(ids), w.shape[1], w.shape[2], w.dtype, sms))) for w, _ in ws]}
            out[f"target{target}"] = row
    finally:
        mm._GATHER_BLOCKS_PER_SM = default
    return out


def sweep_grouped_rows(gen, sms: int) -> dict:
    gsz = torch.tensor([3, 2, 0, 4, 1, 2, 3, 1], device="cuda")
    weights = dict(zip(SHAPES, _int8_experts(gen, 8, SHAPES)))
    xs = {k: torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    default = mm._GROUPED_BLOCKS_PER_SM
    out = {"kernel": "moe_grouped", "group_sizes": gsz.tolist(), "default_target": default}
    try:
        for target in TARGETS:
            mm._GROUPED_BLOCKS_PER_SM = target
            row = {}
            for names in (("gate", "up"), ("down",)):
                def run(names=names):
                    for p in names:
                        w, s = weights[p]
                        mm.grouped_rows(xs[w.shape[1]], w, s, gsz)
                k, n = SHAPES[names[0]]
                row["/".join(names)] = {
                    "graph_ms": _graph_ms(run, reps=4),
                    "slices": len(mm.grouped_rows_slices(k, mm.grouped_rows_plan(
                        16, 8, k, n, torch.int8, sms)))}
            out[f"target{target}"] = row
    finally:
        mm._GROUPED_BLOCKS_PER_SM = default
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
    out = {"kernel": "paged_attention",
           "default_targets": (pa.decode_blocks_per_sm(128), pa._CHUNK_BLOCKS_PER_SM)}
    try:
        for target in TARGETS:
            pa._DECODE_BLOCKS_PER_SM = {hd: target for hd in pa.KERNEL_HEAD_DIMS}
            pa._CHUNK_BLOCKS_PER_SM = target
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
    sweeps = {"gather": sweep_gather, "grouped_rows": sweep_grouped_rows,
              "grouped_int4": sweep_grouped_int4, "int8": sweep_int8,
              "int4_decode": sweep_int4_decode, "int4_a8": sweep_int4_a8,
              "gather_int4": sweep_gather_int4, "paged": sweep_paged}
    for name in sys.argv[1:] or list(sweeps):
        print(json.dumps(sweeps[name](gen, sms)), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
