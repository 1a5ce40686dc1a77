"""Prefill and decode of the Llama-3.1-8B-shaped (or, with ``--moe``, the
Mixtral-8x7B-shaped) decoder on one card.

    python3 -m ragmeup_tpu_torch.tools.decode_profile [--quantization int4 [--w4a8]]
    python3 -m ragmeup_tpu_torch.tools.decode_profile --moe [--quantization int4 [--w4a8]]
    python3 -m ragmeup_tpu_torch.tools.decode_profile --moe --moe-grouped on

int8 weights (the default) run twice, with the CUDA kernels and with their
plain PyTorch versions (``quant_kernel`` and ``use_flash`` off). int4
weights (W4A16 with 128-row scale groups, or W4A8 with 512-row groups) and
the MoE decoders run once: their matmul kernels have no switch, since a
CUDA tensor of a routable shape always launches its kernel (the MoE
prefill takes the all-experts einsum over stacks dequantized in bf16, or
with ``--moe-grouped on`` the grouped route, #12's full-stack kernel for
int8 experts; its decode the expert gather: #10 for int8 experts, #13 for
int4 ones).
Random weights are drawn on the card as chip_smoke.py draws them at its
default seed. For each run it prints one JSON line:

- ``prefill_ms``: one prefill of a 1000-token prompt (bucket 1024, cache
  2048), host clock around a synchronised call, second of two calls;
- ``decode_ms_per_token``: 32 greedy decode steps after 4 warm-up steps;
- ``device_ms_per_token``: over 8 more decode steps under
  ``torch.profiler``, the union of the card's kernel, memcpy and memset
  intervals (from the trace, so overlapping work is counted once);
- ``device_busy_share``: that over ``decode_ms_per_token``. The profiler's
  own host work stretches the profiled steps (``profiled_wall_ms_per_token``)
  and not the device's, so the share is taken against the unprofiled time;
- ``matmul_ms_per_token`` / ``weight_TBps``: device time per token of the
  quantized matmul kernels (int8: partial + split-K reduce; int4 also the
  W4A8 row quantization) and the weight bytes they read per token (codes
  and scales) over it; for the MoE decoder these are the attention
  projections', and ``expert_ms_per_token`` / ``expert_weight_TBps`` the
  expert gather's (partials and reduce) over the routed experts' codes
  and scales (top_k experts per layer per token; packed int4 with their
  group scales for int4 experts);
- ``top``: the device's largest kernels per token;
- ``prefill_device_ms``: one more prefill under ``torch.profiler``, the
  union of its device intervals, and ``prefill_top`` its largest kernels
  (ms per prefill).

The card's name and power limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch

SEED = 2  # chip_smoke.py's decoder seed (its --seed 0, plus 2)
PROMPT_TOKENS = 1000
DECODE_TOKENS = 32
PROFILED_TOKENS = 8
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_intervals(prof) -> list:
    """(name, start_us, end_us) of every device event in the trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") in _DEVICE_CATS and "dur" in e]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile(llm, label: str, weight_bytes: int, expert_bytes: int = 0) -> dict:
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(4, min(120000, llm.cfg.vocab_size), (PROMPT_TOKENS,),
                           generator=gen).tolist()
    n = len(prompt)
    cache_len = llm._bucket(n + 64)
    ids = llm._padded(prompt, llm._bucket(n))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = llm._prefill(ids, n, cache_len)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        with torch.profiler.profile(activities=acts) as prof:
            llm._prefill(ids, n, cache_len)
            torch.cuda.synchronize()
        prefill_dev = _device_intervals(prof)
        tok, pos = int(torch.argmax(logits)), n
        for _ in range(4):
            tok = int(torch.argmax(llm._decode(tok, pos, caches)))
            pos += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TOKENS):
            tok = int(torch.argmax(llm._decode(tok, pos, caches)))
            pos += 1
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / DECODE_TOKENS
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED_TOKENS):
                tok = int(torch.argmax(llm._decode(tok, pos, caches)))
                pos += 1
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = _device_intervals(prof)
    if not dev:
        raise RuntimeError("the profiler traced no device work")
    per_kernel: dict = {}
    for name, s, e in dev:
        per_kernel[name] = per_kernel.get(name, 0.0) + (e - s)
    mm_us = sum(t for k, t in per_kernel.items()
                if "rk_int8_matmul" in k or "rk_int4" in k or "rk_quantize_rows" in k)
    mm_ms = mm_us / PROFILED_TOKENS / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    device_ms = _union_us(dev) / PROFILED_TOKENS / 1e3
    moe = {}
    if expert_bytes:
        ex_ms = sum(t for k, t in per_kernel.items()
                    if "rk_moe_gather" in k) / PROFILED_TOKENS / 1e3
        moe = {"expert_ms_per_token": ex_ms,
               "expert_weight_TBps": expert_bytes / (ex_ms * 1e-3) / 1e12 if ex_ms else None}
    prefill_kernels: dict = {}
    for name, s, e in prefill_dev:
        prefill_kernels[name] = prefill_kernels.get(name, 0.0) + (e - s)
    return {
        "label": label,
        "prefill_ms": prefill_s * 1e3,
        "prefill_device_ms": _union_us(prefill_dev) / 1e3,
        "prefill_top": [(k[:80], t / 1e3) for k, t in
                        sorted(prefill_kernels.items(), key=lambda kv: -kv[1])[:6]],
        "decode_ms_per_token": decode_s * 1e3,
        "device_ms_per_token": device_ms,
        "device_busy_share": device_ms / (decode_s * 1e3),
        "profiled_wall_ms_per_token": wall_us / PROFILED_TOKENS / 1e3,
        "matmul_ms_per_token": mm_ms,
        "weight_TBps": weight_bytes / (mm_ms * 1e-3) / 1e12 if mm_us else None,
        **moe,
        "top": [(k[:80], t / PROFILED_TOKENS / 1e3) for k, t in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quantization", choices=("int8", "int4"), default="int8")
    ap.add_argument("--w4a8", action="store_true",
                    help="int4 with int8 activations (512-row scale groups)")
    ap.add_argument("--moe", action="store_true",
                    help="the Mixtral-8x7B-shaped decoder")
    ap.add_argument("--moe-grouped", choices=("auto", "on"), default="auto",
                    help="the MoE layers' grouped route (LlamaConfig.moe_grouped); "
                         "'on' sends prefill through #12")
    args = ap.parse_args()
    if args.w4a8 and args.quantization != "int4":
        ap.error("--w4a8 needs --quantization int4")
    if args.moe_grouped != "auto" and not args.moe:
        ap.error("--moe-grouped needs --moe")
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: no CUDA device")
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM,
                                                  init_decoder_params)
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    shape = LlamaConfig.mixtral_8x7b if args.moe else LlamaConfig.llama31_8b
    cfg = select_kernels(shape(quantization=args.quantization, int4_w4a8=args.w4a8))
    if args.moe:
        cfg = dataclasses.replace(cfg, moe_grouped=args.moe_grouped)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_decoder_params(cfg, gen, "cuda")
    weight_bytes = sum(t.numel() * t.element_size() for k, t in params.items()
                       if k.rsplit(".", 1)[-1] in ("kernel_q", "scale", "kernel_p",
                                                    "gscale"))
    # routed experts per token: top_k of each MoE layer's E experts
    expert_bytes = sum(t.numel() * t.element_size() for k, t in params.items()
                       if k.rsplit(".", 1)[-1].split("_")[0] in ("gate", "up", "down"))
    expert_bytes = expert_bytes * cfg.num_experts_per_tok // max(cfg.num_experts, 1)
    variant = ("W4A8" if args.w4a8 else "W4A16" if args.quantization == "int4"
               else "int8")
    if args.moe:
        variant = f"Mixtral {variant}" + (", moe_grouped on" if args.moe_grouped == "on" else "")
    runs = [(f"{variant} kernels", cfg)]
    if args.quantization == "int8" and not args.moe:
        runs.append(("int8 plain", dataclasses.replace(cfg, quant_kernel=False,
                                                       use_flash=False)))
    for label, c in runs:
        llm = LocalLLM(c, None, params=params, device="cuda")
        kernels.reset_counts()
        print(json.dumps(profile(llm, label, weight_bytes, expert_bytes)), flush=True)
        counts = kernels.launch_counts()
        if any(counts.values()) != label.endswith("kernels"):
            raise AssertionError(f"{label} run launched {counts}")
        del llm
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
