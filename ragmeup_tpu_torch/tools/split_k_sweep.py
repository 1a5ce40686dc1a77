"""The int4 grouped kernel's split-K target against its neighbours, on one card.

    python3 -m ragmeup_tpu_torch.tools.split_k_sweep

Times #14 (csrc/moe_matmul_int4.cu) on the padded layout at Mixtral-8x7B's
batched-decode shapes: 16 rows (8 tokens routed top-2 over 8 experts by a
seeded random router) against packed int4 experts of groups 128 and 512,
the gate/up pair (k 4096, n 14336) and the down projection (k 14336, n
4096) apart. ``grouped_int4_plan`` aims at ``_INT4_BLOCKS_PER_SM`` blocks
an SM; each target of 1 to 16 is timed in turn (CUDA events, median of
five rounds of ten calls after warm-up), with the slice counts it gives.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from ragmeup_tpu_torch.ops import moe_matmul as mm

SHAPES = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
TARGETS = (1, 2, 4, 8, 16)


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("split_k_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.stack([torch.randperm(8, generator=gen, device="cuda")[:2]
                       for _ in range(8)]).flatten()
    gsz = torch.bincount(ids, minlength=8)
    padded = {k: mm.scatter_layout(torch.randn(16, k, generator=gen, device="cuda")
                                   .to(torch.bfloat16), gsz, 16, 8) for k in (4096, 14336)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    default = mm._INT4_BLOCKS_PER_SM
    out = {"group_sizes": gsz.tolist(), "default_target": default}
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
