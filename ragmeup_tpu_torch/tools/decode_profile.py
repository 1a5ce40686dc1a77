"""Prefill and decode of the Llama-3.1-8B-shaped int8 decoder on one card,
with the CUDA kernels and with their plain PyTorch versions.

    python3 -m ragmeup_tpu_torch.tools.decode_profile

Random weights are drawn on the card as chip_smoke.py draws them at its
default seed; both runs share them. For each run it prints one JSON line:

- ``prefill_ms``: one prefill of a 1000-token prompt (bucket 1024, cache
  2048), host clock around a synchronised call, second of two calls;
- ``decode_ms_per_token``: 32 greedy decode steps after 4 warm-up steps;
- ``device_ms_per_token``: over 8 more decode steps under
  ``torch.profiler``, the union of the card's kernel, memcpy and memset
  intervals (from the trace, so overlapping work is counted once);
- ``device_busy_share``: that over ``decode_ms_per_token``. The profiler's
  own host work stretches the profiled steps (``profiled_wall_ms_per_token``)
  and not the device's, so the share is taken against the unprofiled time;
- ``int8_matmul_ms_per_token`` / ``int8_TBps``: device time of the int8
  kernels per token (partial + split-K reduce) and the int8 weight bytes
  read per token over it;
- ``top``: the device's largest kernels per token.

The card's name and power limit come first, as nvidia-smi reports them.
"""

from __future__ import annotations

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


def profile(llm, label: str, int8_bytes: int) -> dict:
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(4, 120000, (PROMPT_TOKENS,), generator=gen).tolist()
    n = len(prompt)
    cache_len = llm._bucket(n + 64)
    ids = llm._padded(prompt, llm._bucket(n))
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = llm._prefill(ids, n, cache_len)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
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
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
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
    int8_us = sum(t for k, t in per_kernel.items() if "rk_int8_matmul" in k)
    int8_ms = int8_us / PROFILED_TOKENS / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    device_ms = _union_us(dev) / PROFILED_TOKENS / 1e3
    return {
        "label": label,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_token": decode_s * 1e3,
        "device_ms_per_token": device_ms,
        "device_busy_share": device_ms / (decode_s * 1e3),
        "profiled_wall_ms_per_token": wall_us / PROFILED_TOKENS / 1e3,
        "int8_matmul_ms_per_token": int8_ms,
        "int8_TBps": int8_bytes / (int8_ms * 1e-3) / 1e12 if int8_us else None,
        "top": [(k[:80], t / PROFILED_TOKENS / 1e3) for k, t in top],
    }


def main() -> int:
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
    cfg = select_kernels(LlamaConfig.llama31_8b())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_decoder_params(cfg, gen, "cuda")
    int8_bytes = sum(t.numel() for k, t in params.items() if k.endswith("kernel_q"))
    plain_cfg = dataclasses.replace(cfg, quant_kernel=False, use_flash=False)
    for label, c in (("kernels", cfg), ("plain", plain_cfg)):
        llm = LocalLLM(c, None, params=params, device="cuda")
        kernels.reset_counts()
        print(json.dumps(profile(llm, label, int8_bytes)), flush=True)
        counts = kernels.launch_counts()
        if any(counts.values()) != (label == "kernels"):
            raise AssertionError(f"{label} run launched {counts}")
        del llm
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
