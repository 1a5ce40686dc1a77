"""One /chat path of the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels of ragmeup_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it, with the stated tolerance; median times of
   both, from CUDA events.
4. system: full-width models with random weights drawn on the card from
   --seed (GIST-small-shaped encoder, MiniLM-L-6-shaped cross-encoder,
   Llama-3.1-8B-shaped int8 decoder), a generated corpus of N_DOCS short
   documents (16 top-k tiles of 1024), RagSystem ingest → embed → index,
   then three chat() requests on the default config (hybrid 0.5/0.5, MMR,
   bf16 index, rerank, rewrite loop, Re2, rerank provenance) with
   MAX_NEW_TOKENS per answer; the third sends history. Each LLM call of a
   request is timed on its own. The kernels' launch counts are reset
   before the requests and must all be non-zero after them.

Prints a JSON line with the kernels' results, then the card's name and
power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
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

def check_topk(gen, n_cols: int) -> dict:
    """K1 at the retrieval shapes: d = 384, the smoke corpus capacity, dead
    and padding columns, exact duplicates. Ids must match exactly; scores
    to 1e-5 (bf16 products are exact in f32, only the sum order differs)."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    d = 384
    c = torch.randn(n_cols, d, generator=gen, device="cuda")
    c = c / c.norm(dim=1, keepdim=True)
    c[100:110] = c[50]            # exact ties: the lowest index must win
    corpus_t = c.T.contiguous().to(torch.bfloat16)
    mask = torch.zeros(1, n_cols, device="cuda")
    mask[0, n_cols - 300:] = topk.NEG_INF                 # padding tail
    mask[0, torch.randperm(n_cols - 300, generator=gen, device="cuda")[:500]] = topk.NEG_INF
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


DECODE_SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
                 "o": (4096, 4096), "gate": (4096, 14336), "up": (4096, 14336),
                 "down": (14336, 4096)}


def check_int8_matmul(gen) -> dict:
    """K2 at the 8B decode projections, m in {1, 8}, bf16. Tolerance: one
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


def check_flash(gen) -> dict:
    """K3 at an 8B prefill: nkv = 8, g = 4, hd = 128, s = 1024, kv_len = 2048,
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


def build_models(seed: int):
    import torch
    from ragmeup_tpu_torch.models.cross_encoder import CrossEncoder
    from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM,
                                                  init_decoder_params)
    from ragmeup_tpu_torch.models.encoder import BertConfig, SentenceEncoder
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    enc_cfg = BertConfig()                        # GIST-small shape
    encoder = SentenceEncoder(enc_cfg, SimpleTokenizer(enc_cfg.vocab_size),
                              seed=seed, device="cuda")
    ce_cfg = BertConfig(num_layers=6)             # MiniLM-L-6 shape
    cross = CrossEncoder(ce_cfg, SimpleTokenizer(ce_cfg.vocab_size),
                         seed=seed + 1, device="cuda")
    llm_cfg = select_kernels(LlamaConfig.llama31_8b())
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_decoder_params(llm_cfg, gen, "cuda")
    llm = LocalLLM(llm_cfg, SimpleTokenizer(llm_cfg.vocab_size), params=params,
                   eos_ids=(128001, 128009), device="cuda")
    return encoder, cross, llm


def check_decoder(llm) -> float:
    """Decode against prefill: the logits of one decode step (int8 kernel,
    einsum attention over the cache) must match a prefill of the same
    tokens (flash kernel, dequantized matmuls) up to bf16 noise."""
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
    if cos < 0.99:
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


def run_system(seed: int) -> dict:
    import torch
    from ragmeup_tpu.config import RagConfig
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.pipeline.system import RagSystem

    t0 = time.perf_counter()
    encoder, cross, llm = build_models(seed)
    torch.cuda.synchronize()
    log(f"models built on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    cos = check_decoder(llm)
    log(f"decoder: decode step vs prefill logits cosine {cos:.5f}")
    llm_calls = time_llm_calls(llm)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        texts = write_corpus(data_dir, N_DOCS, seed)
        cfg = RagConfig()
        cfg.data.data_directory = data_dir
        cfg.data.index_directory = os.path.join(tmp, "index")
        cfg.generation.max_new_tokens = MAX_NEW_TOKENS
        t0 = time.perf_counter()
        system = RagSystem(cfg, encoder=encoder, cross_encoder=cross, llm=llm,
                           device="cuda")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        log(f"ingest + embed + index: {system.dense.n} chunks, capacity "
            f"{system.dense.capacity}, {ingest_s:.1f} s")
        if system.dense.n != N_DOCS:
            raise AssertionError(f"{system.dense.n} chunks for {N_DOCS} docs")

        # a stored vector must find itself first (cosine 1)
        rows = [0, 4242, N_DOCS - 1]
        hits = system.dense.search(system.dense.gather_rows(rows), 1)
        if [h[0][0] for h in hits] != rows:
            raise AssertionError(f"self-retrieval failed: {hits}")

        words = texts[7].split()
        queries = [f"What do the notes say about {' '.join(words[:3])}?",
                   f"Which notes mention {' '.join(texts[4242].split()[:2])}?",
                   "Tell me more about that."]
        kernels.reset_counts()
        latencies, outs = [], []
        history = []
        for i, q in enumerate(queries):
            first_call = len(llm_calls)
            t0 = time.perf_counter()
            out = system.chat(q, history if i == 2 else None)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            outs.append(out)
            if i == 1:
                history = out["history"]
            log(f"request {i + 1}: {latencies[-1] * 1e3:.1f} ms, "
                f"fetched={out['fetched_new_documents']} "
                f"rewritten={out['rewritten']} docs={len(out['documents'])} "
                f"reply={out['reply'][:60]!r} timings="
                + json.dumps({k: round(v, 1) for k, v in out["timings"].items()}))
            log(f"  LLM calls (prompt tokens, new tokens, ms): "
                f"{[(p, n, round(ms, 1)) for p, n, ms in llm_calls[first_call:]]}")
        counts = kernels.launch_counts()
        log(f"launch counts over the three requests: {counts}")

    for i, out in enumerate(outs):
        if not out["reply"]:
            raise AssertionError(f"request {i + 1}: empty reply")
        if out["fetched_new_documents"]:
            docs = out["documents"]
            if not docs:
                raise AssertionError(f"request {i + 1}: no documents")
            for d in docs:
                if not 0 <= d["pk"] < N_DOCS or not math.isfinite(d["provenance"]):
                    raise AssertionError(f"request {i + 1}: bad document {d}")
        elif out["documents"]:
            # a follow-up whose fetch decision says no answers from its
            # history and carries no documents (the pipeline's contract)
            raise AssertionError(f"request {i + 1}: documents without a fetch")
    if not outs[0]["fetched_new_documents"] or not outs[1]["fetched_new_documents"]:
        raise AssertionError("a first-turn request must fetch documents")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return {"counts": counts, "latency_s": latencies, "ingest_s": ingest_s,
            "decode_prefill_cosine": cos}


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
    }
    for name, (r, _, _) in results.items():
        log(f"kernel {name}: {json.dumps(r)}")

    system = run_system(args.seed)
    lat = system["latency_s"]
    log(f"/chat latency per request (s): {[round(x, 3) for x in lat]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": system["counts"][name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, (r, src, rep) in results.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
