"""The /chat paths of the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels of ragmeup_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, with the stated tolerance; median times of
   both, from CUDA events.
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

Each LLM call of a request is timed on its own. Each of the three runs of
requests resets the kernels' launch counts just before its requests and
reads them just after; every kernel of that run's path must have launched.

Prints a JSON line with the kernels' results, then the card's name and
power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_DOCS = 16384          # 16 top-k tiles of 1024 columns
MAX_NEW_TOKENS = 32     # generation.max_new_tokens of the answer


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


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
    return {"max_abs_err": err,
            "ms": median_ms(lambda: topk.dense_topk(q, corpus_t, 20, mask=mask)),
            "plain_ms": median_ms(lambda: topk.dense_topk_plain(q, corpus_t, 20, mask=mask)),
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
            "plain_ms": median_ms(lambda: topk.dense_topk_int8_plain(
                q, corpus, c_scale, 20, mask=mask)),
            "shape": f"b=1 d={d} N={n_cols} k=20 int8"}


DECODE_SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
                 "o": (4096, 4096), "gate": (4096, 14336), "up": (4096, 14336),
                 "down": (14336, 4096)}


def check_int8_matmul(gen) -> dict:
    """#3 at the 8B decode projections, m in {1, 8}, bf16. Tolerance: one
    bf16 ulp of the largest output (2^-7 * max |ref|): both sides sum in
    f32 and round once. Times: the 7 projections of one layer at m = 1 in
    sequence (218 MB of int8, beyond the 50 MB L2, as decode reads it)."""
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
    xs = {k: torch.randn(1, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}

    def layer(fn):
        return lambda: [fn(xs[w.shape[0]], w, s) for w, s in weights.values()]
    per_shape = {name: round(median_ms(lambda w=w, s=s: qm.int8_matmul(
        xs[w.shape[0]], w, s)), 4) for name, (w, s) in weights.items()}
    return {"max_abs_err": err, "ms": median_ms(layer(qm.int8_matmul), reps=10),
            "plain_ms": median_ms(layer(qm.int8_matmul_plain), reps=10),
            "shape": "one decode layer: 7 projections at m=1, bf16",
            "per_shape_ms_l2_warm": per_shape}


def check_int4(gen, a8: bool) -> dict:
    """#4 (W4A16, groups 128 and 512: the quality and the output-scaled
    route) or #5 (W4A8, group 512) at the 8B projection shapes for m in
    {1, 8, 256}, bf16, on random packed bytes and scales. Tolerance: one
    bf16 ulp of the largest output (2^-7 * max |ref|): both versions sum in
    f32 and round once (W4A8: exact integer sums, the same epilogue order).
    Times: the 7 projections of one layer in sequence at m = 1 (109 MB of
    packed int4, beyond the 50 MB L2, as decode reads it) and at m = 256."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    plain = qm.int4_matmul_a8_plain if a8 else qm.int4_matmul_plain

    def kernel(x, w, s):
        return qm.int4_matmul(x, w, s, a8=a8)
    err, times = 0.0, {}
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
        for m in (1, 256):
            xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k in (4096, 14336)}

            def layer(fn, xs=xs, weights=weights):
                return lambda: [fn(xs[2 * w.shape[0]], w, s) for w, s in weights.values()]
            reps = 10 if m == 1 else 2
            times[f"group{group}_m{m}"] = (median_ms(layer(kernel), reps=reps),
                                           median_ms(layer(plain), reps=reps))
    ms, plain_ms = times["group512_m1" if a8 else "group128_m1"]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "shape": f"one decode layer: 7 projections at m=1, bf16, group "
                     f"{512 if a8 else 128}",
            "layer_ms_kernel_plain": {k: [round(a, 4), round(b, 4)]
                                      for k, (a, b) in times.items()}}


def check_flash(gen) -> dict:
    """#7/#8 at an 8B prefill: nkv = 8, g = 4, hd = 128, s = 1024, kv_len = 2048,
    bf16. Tolerance 2e-2 absolute: two bf16 ulps at |out| < 2 (the plain
    version keeps f32 throughout, the kernel too; only the final rounding
    and the sum order differ)."""
    import torch
    from ragmeup_tpu_torch.ops import attention
    q = torch.randn(8, 4, 1024, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(8, 2048, 128, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(8, 2048, 128, generator=gen, device="cuda").to(torch.bfloat16)
    o1 = attention.flash_attention_gqa(q, k, v)
    o0 = attention.flash_attention_gqa_plain(q, k, v)
    torch.cuda.synchronize()
    err = (o0.float() - o1.float()).abs().max().item()
    if not err <= 2e-2:
        raise AssertionError(f"flash_attention_gqa differs by {err}")
    return {"max_abs_err": err,
            "ms": median_ms(lambda: attention.flash_attention_gqa(q, k, v), reps=5),
            "plain_ms": median_ms(lambda: attention.flash_attention_gqa_plain(q, k, v), reps=5),
            "shape": "bkv=8 g=4 s=1024 kv_len=2048 hd=128 bf16"}


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


def build_llm(seed: int, **quant):
    """The Llama-3.1-8B-shaped decoder, weights drawn and quantized on the
    card (int8 by default; ``quantization="int4"``, ``int4_w4a8``)."""
    import torch
    from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM,
                                                  init_decoder_params)
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    t0 = time.perf_counter()
    llm_cfg = select_kernels(LlamaConfig.llama31_8b(**quant))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_decoder_params(llm_cfg, gen, "cuda")
    llm = LocalLLM(llm_cfg, SimpleTokenizer(llm_cfg.vocab_size), params=params,
                   eos_ids=(128001, 128009), device="cuda")
    torch.cuda.synchronize()
    log(f"decoder {llm_cfg.quantization}{' W4A8' if llm_cfg.int4_w4a8 else ''} "
        f"built on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
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
                "int4 W4A8": ("topk_int8", "int4_matmul_a8", "flash_gqa")}


def rag_config(data_dir: str, index_dir: str, **model):
    from ragmeup_tpu.config import RagConfig
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
        if not out["reply"]:
            raise AssertionError(f"{label} request {i + 1}: empty reply")
        if out["fetched_new_documents"]:
            docs = out["documents"]
            if not docs:
                raise AssertionError(f"{label} request {i + 1}: no documents")
            for d in docs:
                if not 0 <= d["pk"] < N_DOCS or not math.isfinite(d["provenance"]):
                    raise AssertionError(f"{label} request {i + 1}: bad document {d}")
        elif i != 2:
            raise AssertionError(f"{label} request {i + 1}: a first turn must fetch")
        elif out["documents"]:
            # a follow-up whose fetch decision says no answers from its
            # history and carries no documents (the pipeline's contract)
            raise AssertionError(f"{label} request {i + 1}: documents without a fetch")
    missing = [k for k in PATH_KERNELS[label] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    return {"counts": counts, "latency_s": latencies}


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_system(seed: int) -> dict:
    """The three runs of requests; returns each run's counts and latencies."""
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
        del system, llm
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
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {  # N_DOCS rows fill the dense index's capacity exactly
        "topk": (check_topk(gen, N_DOCS), "ragmeup_tpu_torch/csrc/topk.cu",
                 "ragmeup_tpu/ops/topk.py:63"),
        "int8_matmul": (check_int8_matmul(gen),
                        "ragmeup_tpu_torch/csrc/quant_matmul.cu",
                        "ragmeup_tpu/ops/quant_matmul.py:27"),
        "flash_gqa": (check_flash(gen), "ragmeup_tpu_torch/csrc/flash_attention.cu",
                      "ragmeup_tpu/ops/attention.py:156"),
        "topk_int8": (check_topk_int8(gen, N_DOCS), "ragmeup_tpu_torch/csrc/topk.cu",
                      "ragmeup_tpu/ops/topk.py:88"),
        "int4_matmul": (check_int4(gen, a8=False),
                        "ragmeup_tpu_torch/csrc/quant_matmul_int4.cu",
                        "ragmeup_tpu/ops/quant_matmul.py:174"),
        "int4_matmul_a8": (check_int4(gen, a8=True),
                           "ragmeup_tpu_torch/csrc/quant_matmul_int4.cu",
                           "ragmeup_tpu/ops/quant_matmul.py:257"),
    }
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
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, (r, src, rep) in results.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
