"""#6, the fused int4 MLP, and its unfused yardstick, timed on one card.

    python3 ragmeup_tpu_torch/tools/mlp_int4_times.py [--tree DIR] [--plans]

Imports ``ragmeup_tpu_torch`` from the checkout at DIR (by default the one
that holds this file), draws Llama-3.1-8B MLP weights (h 4096, I 14336,
group 128: random packed bytes, scales of 1e-3 to 3e-3, seed 0) on the
card, and prints the card's name and power limit, then one JSON line:

- ``fused_graph_ms``: ``fused_mlp_int4`` in bf16 at m = 1 and 8, from a
  CUDA graph's replay (the wrapper's host cost exceeds the kernel's time);
- ``unfused_graph_ms``: the port's unfused int4 MLP at the same shapes
  (RMSNorm, ``int4_matmul`` (#4) for gate, up and down, ``silu * u``, the
  residual add): the yardstick, not one library call;
- ``int4_graph_ms``: #4 alone on the gate and on the down matrix, the rate
  of the tensor-core stream that #4 and #6 share;
- with ``--plans`` (a tree whose wrapper takes a plan): both routes of the
  tensor-core kernels (the last block of a strip sums it, or reduce
  launches) at m = 1, 2, 3, 4 and 8 on the plan's slices, and at m = 1 and
  8 on other slices too (SLICES, packed rows of a gate/up and a down
  slice).

Medians of five rounds after warm-up rounds until two agree within 5 %.
To compare a parent commit on one card, unpack ``git archive <parent>``
into ``build/parent`` and run it in one command in the order parent,
change, change, parent (``--tree build/parent`` for the parent's runs).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

H, INTER, GROUP = 4096, 14336, 128
ROWS = (1, 8)
PLAN_ROWS = (1, 2, 3, 4, 8)     # --plans: both routes on the plan's slices
SLICES = ((256, 128), (128, 128), (256, 256), (256, 64))  # gate/up, down rows (m 1, 8)


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


def unfused_mlp_int4(qm, x, nw, wg, sg, wu, su, wd, sd, eps: float = 1e-5):
    """The MLP from the port's unfused ops (``qm``: its quant_matmul module):
    RMSNorm in f32 rounded to x's dtype, #4 for gate, up and down, ``silu(g)
    * u`` and the residual in x's dtype."""
    import torch
    xf = x.float()
    xn = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps) * nw).to(x.dtype)
    act = torch.nn.functional.silu(qm.int4_matmul(xn, wg, sg)) * qm.int4_matmul(xn, wu, su)
    return x + qm.int4_matmul(act, wd, sd)


def mlp_weights(gen, h: int = H, inter: int = INTER, group: int = GROUP) -> list:
    """[wg_p, gs_g, wu_p, gs_u, wd_p, gs_d] on the card: random packed bytes
    (every byte two valid nibbles), scales of 1e-3 to 3e-3."""
    import torch
    out = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        out.append(torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                                 dtype=torch.int8))
        out.append(torch.rand(k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mlp_int4_times: no CUDA device; this tool runs on a GPU only")
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    if os.path.dirname(os.path.dirname(os.path.abspath(qm.__file__))) != \
            os.path.join(os.path.abspath(args.tree), "ragmeup_tpu_torch"):
        raise SystemExit(f"mlp_int4_times: imported {qm.__file__}, not {args.tree}'s")
    kernels.lib()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = mlp_weights(gen)
    nw = 1.0 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    xs = {m: torch.randn(m, H, generator=gen, device="cuda").to(torch.bfloat16) for m in ROWS}
    result = {"tree": os.path.abspath(args.tree),
              "fused_graph_ms": {m: graph_ms(lambda: qm.fused_mlp_int4(xs[m], nw, *ws))
                                 for m in ROWS},
              "unfused_graph_ms": {m: graph_ms(lambda: unfused_mlp_int4(qm, xs[m], nw, *ws))
                                   for m in ROWS}}
    acts = {m: torch.randn(m, INTER, generator=gen, device="cuda").to(torch.bfloat16)
            for m in ROWS}
    result["int4_graph_ms"] = {
        m: {"gate": graph_ms(lambda: qm.int4_matmul(xs[m], ws[0], ws[1])),
            "down": graph_ms(lambda: qm.int4_matmul(acts[m], ws[4], ws[5]))} for m in ROWS}
    if args.plans:
        sms = kernels.sm_count(0)
        plans = {}

        def timed(label, m, plan):
            plans[f"m={m} {label}"] = graph_ms(
                lambda: qm._fused_mlp_int4_cuda(xs[m], nw, *ws, 1e-5, 512, plan=plan))
        for m in PLAN_ROWS:
            if m not in xs:
                xs[m] = torch.randn(m, H, generator=gen, device="cuda").to(torch.bfloat16)
            base = qm.fused_mlp_int4_plan(m, H, INTER, 512, GROUP, 512, GROUP, torch.bfloat16,
                                          sms)
            slices = SLICES if m in ROWS else ((base.ks_gu, base.ks_dn),)
            for route, (ks_gu, ks_dn) in itertools.product(("last_block", "reduce"), slices):
                timed(f"{route} slices of {ks_gu} / {ks_dn} rows", m,
                      qm.MlpInt4Plan(route, ks_gu, ks_dn))
        result["plans_graph_ms"] = plans
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
