"""The /chat paths of the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels of ragmeup_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, with the stated tolerance (#1 and #2 also at a
   million-column corpus and at 256 queries over 65,536 columns,
   TOPK_SHAPES, with every column masked and k above the live columns,
   on both of their merge routes, each at most two launches a call and #2
   captured in a CUDA graph; #8 and #9 also at the head dims and groups of
   the checkpoint families, FAMILY_SHAPES: #8 at hd 256 with g 1 and 2 and
   at hd 128 with g 7, #9 in both modes at hd 64, 96 and 256 and at g 7,
   each also with a window of 512 over 2,048 tokens, softcap 50 and
   sm_scale 1/16, each a row of the kernels line, its launches counted by
   head dim and group; #9's hd-256 chunk also at the spec waves' q_len 8,
   its hd-64/96 decode at g 1, 2, 7 and 8, each row's kernels traced and
   held to the kernel its mode and head dim take, PAGED_ROUTES);
   median times of
   both, and of one PyTorch library call computing the same function where
   there is one, from CUDA events, each after warm-up rounds until two
   agree within 5 %; the kernel's time also from a CUDA graph's replay
   (graph_ms: the device's time without the wrapper's host cost, which an
   eager loop times once it exceeds the kernel's); the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type); the card's SM and memory clocks before the checks and after
   each.
4a. checkpoints: HF-layout checkpoint directories written under the temp
   dir by tools/synthetic_checkpoint.py, weights drawn on the card from
   --seed (bf16 N(0, 0.02), norms ones): a GIST-small-shaped BERT encoder,
   a MiniLM-L-6-shaped BERT cross-encoder and Llama-3.1-8B (32 layers, 16
   GB in four shards; if the temp disk, probed first, cannot hold it with
   DISK_SPARE to spare, as many whole layers as fit, at least
   CKPT_MIN_LAYERS, which is logged), each with its family's
   tokenizer.json (tools/synthetic_tokenizer.py: BERT's WordPiece,
   Llama-3's byte-level BPE). Each write and each load is logged
   with its seconds, GB and GB/s (a load also with the card's GiB
   allocated after it); the directories are deleted at the end. Before
   them, the tokenizer goldens: each family structure's file built again
   at GOLDEN_SEED and read by the port's reader (models/tokenizer_json.py)
   must give tools/tokenizer_goldens.py's ids for GOLDEN_STRINGS (the
   Llama-3 chat template with its special tokens, emoji, CJK, combining
   marks, U+001C, U+0085, U+00A0, digit runs, 'S / 'll, \r\n).
4. system, default path: RagSystem loads all three models from those
   directories itself (cfg.model.llm_checkpoint with the default int8
   quantization, embedding_checkpoint, cross_encoder_checkpoint); the
   loaded decoder's EOS ids must be {128001, 128009}, and its tensors of
   layers 0, 15 and the last, the embedding, the final norm and the head
   torch.equal to the generic path's quantization of the same checkpoint
   tensors on the card (check_loaded_decoder); decode against prefill.
   Every model RagSystem or a loader takes from a checkpoint here and in
   phases 5-5d must tokenize through the reader (HFTokenizer, never the
   hashing SimpleTokenizer); its kind and vocabulary are logged. After the
   default requests, the host times to tokenize the corpus (a fresh
   tokenizer, cold cache), one rerank wave of pairs and each of the 8B's
   prompts are printed with the card's name and power limit.
   Then a generated corpus of N_DOCS short documents (16 top-k tiles of
   1024), RagSystem ingest → embed → index, and three chat() requests on
   the default config (hybrid 0.5/0.5, MMR, bf16 index, rerank, rewrite
   loop, Re2, rerank provenance) with MAX_NEW_TOKENS per answer; the third
   sends history. The same three requests then run on a decoder of the
   same shape with random weights drawn on the card ("default random"),
   for latencies to hold the checkpoint's against in the same call.
5. system, quantized path: the int8 decoder is freed; a RagSystem with an
   int8 dense index over the same corpus loads the 8B checkpoint as int4
   W4A16 (128-row scale groups), is checked as in phase 4 and answers three
   chat() requests; then a second RagSystem, which loads the saved int8
   index artifact, loads it as int4 W4A8 (512-row groups), checked the
   same way, and answers one. The 8B checkpoint is then deleted.
5b. Mixtral checkpoint: Mixtral-8x7B-v0.1's layout at full width and two
   layers (6.3 GB), loaded by load_local_llm in int8 and in int4, each
   checked as in phase 4 (both layers: expert stacks, router, attention)
   and generating 8 greedy tokens one a forward, which must launch #10
   ("moe checkpoint int8") or #13 ("moe checkpoint int4").
5c. Gemma-2-9B checkpoint (after phase 5 deletes the 8B one): its layout
   at full width and depth (18.5 GB; fewer layers if the temp disk, probed
   first, cannot hold it), loaded int8 by RagSystem beside phase 4a's
   encoders and phase 4's bf16 index, its config, EOS id and layers 0, 21
   and 41 checked as in phase 4, decode against prefill; three default
   requests ("gemma2": #1 and #3, the softcapped prefill through the
   einsum, #8 never), then phase 6's batched /chat ("gemma2 batched": #9 at
   hd 256, g 2, with softcap 50, sm_scale 1/16 and window 4096 on the even
   layers). The directory is deleted after.
5d. four checkpoints at full width and two layers (after phase 5b), each
   loaded by load_local_llm, checked as in phase 5b and driven: Gemma-7B
   int8 (8 greedy tokens after 1,024 prompt tokens: #8 at hd 256; one
   request through the paged engine: #9 at hd 256); Phi-3-mini-4k int8 and
   int4 (its packed tensors split; a 2,500-token prompt past its 2,047-token
   window: the engine's prefill logits within cosine 0.99 of the dense
   prefill's; #9 at hd 96); Qwen2.5-7B int8 (its biases equal to the
   checkpoint's; #8 and #9 at g 7); Qwen3-30B-A3B int8 (#10, 8 slots) and
   int4 (#13, its n = 768 route). Each directory is deleted after.
6. system, batched path (run right after phase 4, on its int8 decoder and
   index artifact): a RagSystem with server.batched_llm serves /chat
   through the paged engine (512 pages of 128 tokens per layer, 8-step
   waves, prefix cache, temperature 0.2): four first turns sent at once
   from four threads, then a follow-up with history. Prints the backend's
   TTFT and tok/s percentiles and the engine's wave timings; checks the
   prefix-cache hits and that every page is free or registered after stop.
6b. system, greedy ("greedy", right after phase 6, on phase 4's int8
   decoder and bf16 index, before it is freed): speculative decoding.
   Three chat() requests at temperature 0 ("greedy": generate_speculative's
   verify forwards launch #3 at m = 8, counted by a spy on the decoder's
   int8_matmul; prints verify forwards, accepted drafts and tokens a
   forward); one 8-token verify forward after 1,000 and after 24 tokens
   against 8 decode steps and against a prefill of the same tokens (cosine
   SPEC_COS and |logit difference| SPEC_LOGIT_TOL, which the same forward
   with its in-chunk mask dropped or its positions off by one must fail);
   a ~1,000-token prompt through generate(speculative="auto") and
   (speculative="off"), 32 tokens at repetition penalty 1.1, which must be
   equal but for a first difference where the plain path's penalized
   margin between the two tokens is at most twice the verify forward's
   largest |logit difference| from the decode steps; forced acceptance
   (the final norm's weight zeroed, so every logit is 0 and the argmax
   token 0; a prompt ending in 16 zeros): 32 tokens in at most 5 verify
   forwards, and one engine request done in its first spec wave of 8
   iterations where plain 8-step waves take 4; the fused generate loop
   against the host loop on a sampled reply ending in EOS (equal tokens;
   the forwards each ran after EOS); the paged engine at temperature 0
   ("greedy batched": four first turns at once, then a follow-up, through
   speculative waves and the adaptive gate, which must have dispatched two
   spec waves before it demotes; #9's chunk mode must launch from the spec
   waves); blockwise
   attention provenance (span_attention_mass over qk_forward) against the
   last layer of attention_forward on a 1,024-token thread, each span's
   mass within SPAN_TOL (relative), and again with the queries scaled so
   that attention is far from uniform, where a dropped sm_scale and a
   dropped causal mask must miss SPAN_TOL; one chat() with
   provenance_method="attention" through the blockwise branch, whose
   scores must sum to 1.
4h. the HTTP layer (right after phase 6b, on phase 4's models and copies
   of its data and index directories, before phase 5 deletes the 8B
   checkpoint): the port's RagServer on server/wsgi.py's threaded server
   (127.0.0.1, a free port, in a thread), driven with urllib only.
   "http": /health (the store's live chunks), /get_documents, three /chat
   (two first turns, then a follow-up sending the second's history and
   documents: contract keys, documents fetched on first turns, the
   client's documents back when nothing is fetched), each logged beside
   phase 4's in-process latency of the same query; a multipart
   /add_document of a new CSV (/health grows by its chunks), /search with
   a session id, /feedback posted and read back, /get_document (the
   file's bytes), /delete (the added chunks), /deepeval_evaluate (one
   pair, every score in [0, 1]), /stats, GET / (HTML) and an unknown path
   (404). "http batched": server.batched_llm, four first turns at once
   from four threads, then a follow-up; /stats must carry TTFT and tok/s
   percentiles and prefix-cache lookups. GraphRAG: graph.enabled on the
   native store (rewrite loop off), a CSV of GRAPH_ROWS uploaded over HTTP
   becomes as many Row nodes; one /chat makes exactly one decoder call
   more (the Cypher; random weights give none that parses, so the graph
   adds no chunk) than the same request on a system without the graph;
   then python -m ragmeup_tpu_torch.graph.sidecar in a subprocess answers
   an add_instances / run round trip through the port's RemoteGraphClient.
   The entry point: python -m ragmeup_tpu_torch.server in a subprocess,
   configured by an env file (llm_model: the 8B checkpoint; a third copy
   of the directories; the .env format names no encoder checkpoint, so it
   loads the default encoders at embedding_dim 384 beside the copied
   index), must answer /health within SERVER_UP_S and one /chat with a
   reply; its seconds to come up, the card's free memory before it and
   its exit code after SIGTERM are logged. Last, whether werkzeug and
   requests are importable on the machine (a record: the port uses
   neither).
4i. retrieval at scale (right after phase 4h, on phase 4's models and
   copies of its directories, before phase 5 deletes the 8B checkpoint),
   the corpus sharded over SHARDS shards that all sit on cuda:0 (a mesh's
   device list may repeat a device): (a) sharded_topk at S2 (1,048,576
   columns, d 384, k 20) for b 1 and 32, bf16 (#1) and int8 (#2), each
   call SHARDS launches of its kernel, ids equal to the unsharded kernel's
   and the plain version's (#2's scores too; #1 under phase 3's near-tie
   rule), eager and graph ms beside the unsharded kernel's; (b) IVF on
   IVF_N clustered rows (IVF_BLOBS Gaussian blobs from a seeded
   generator, K = sqrt(n)): fit seconds, memory_bytes and the k-means
   score matrix's bytes, search ms and recall@20 against #1's exact ids at
   nprobe 8 and 32 for b 1 and 32 beside #1's ms, and a full probe over
   IVF_EXACT_N rows equal to #1 under the near-tie rule; (c) RagSystem
   with parallel.corpus_axis = SHARDS loads phase 4's index artifact into
   ShardedDenseIndex beside phase 4's int8 decoder: 32 queries retrieve
   the single-device system's chunk ids, and one default /chat at
   temperature 0 ("corpus sharded": #1, #3, #8) fetches the single-device
   system's documents; then one /chat with retrieval.ann = "ivf" on one
   device ("ivf": #3 and #8; the IVF view is fitted on its first search);
   (d) STREAM_BATCHES batches of STREAM_B queries through
   hybrid_fused_search_stream over phase 4's bf16 index and an int8 copy,
   equal to hybrid_fused_search batch by batch, both timed.
4j. the model axis (right after phase 4i, on phase 4's models, checkpoint
   and copies of its directories, before phase 5 deletes the 8B
   checkpoint), every shard on cuda:0; its requests answer in
   TP_NEW_TOKENS tokens with the rewrite loop off (one generation a first
   turn): (a) "tp4": RagSystem with parallel.model_axis = MODEL_SHARDS
   loads the 8B int8 checkpoint over the model axis; its shards of three
   layers, the embedding, the norm and the head torch.equal to
   tp_shard_model's cut of phase 4's decoder; the one-device decoder's
   greedy stream of TP_STEPS tokens after a TP_PROMPT-token prompt fed
   through both decoders, the prefill's and every decode step's logits
   within TP_CAPS["8b"] (largest and mean |difference|, cosine), each of
   the sharded decoder's own picks the stream's token or a near-tie
   (margin at most twice that step's gap); the GiB of both
   LLMs' weights; three requests, whose launches by shard must be #3 at
   5 projections a layer each decode forward (k_proj and v_proj, 256
   local columns, take the fallback) and #8 once a layer each prefill,
   on every shard; (b) "tp4 batched": the paged engine on per-shard pools
   (2 kv heads a shard) with four first turns at once and a follow-up
   (#9 decode and chunk at hd 128 g 4, equal launches on every shard);
   (c) "ring": corpus_axis 2 x model_axis 2 over phase 4's weights, the
   prefill logits held as in (a) and one /chat whose every prefill rings
   (2 x 32 ring calls a prefill, #8 never; #3 on all 7 projections at 2
   shards); (d) "moe ep int8" / "moe ep int4": Mixtral-8x7B's shape at
   two layers drawn on the card, one device against 4 model shards (2
   experts a shard) on the same weights: prefill logits within
   TP_CAPS["moe"], 8 greedy tokens on one device, then on the mesh alone
   with the counts reset just before (each decode step through the
   expert-parallel gather, #10 or #13, on every shard), the streams
   held; (e) "tp4 w4a16": the 8B checkpoint loaded int4 W4A16 over 4
   shards, one request, #4 at the 5 projections that pass the local gate
   on every shard.
7. system, sparse-MoE path: the int4 decoders are freed; a
   Mixtral-8x7B-shaped int8 decoder at MOE_SMOKE_LAYERS of its 32 layers
   with random weights drawn on the card (8 experts, top-2; 24 GB) with the
   bf16 index of phase 4 answers three chat() requests ("moe": decode
   through #10, prefill through the all-experts einsum); a second decoder
   over the same weights with moe_grouped="on" answers one ("moe
   grouped": prefill through #12); then the paged engine on the first
   serves eight first turns at once and a follow-up ("moe batched": waves
   of 8 rows, 16 (token, expert) slots, through #11). Decode against
   prefill compares the last token's routed experts layer by layer.
8. system, int4 sparse-MoE path: the int8 Mixtral decoder is freed; the
   same shape with packed int4 experts (group 128; about 13 GB) answers
   three chat() requests ("moe int4": decode through #13, prefill through
   the stacks dequantized in bf16), then serves eight first turns at once
   and a follow-up through the paged engine ("moe int4 batched": 8-row
   waves through #14); a W4A8 int4 decoder (512-row groups) answers one
   ("moe int4 W4A8": #5 and #13's output-scaled route). #6 (the fused int4
   MLP) is on no path, as in the JAX package: phase 3 checks it alone.
9. training (after phase 8, the encoders freed): train/train.py's
   make_decoder_train_step at full width, f32 weights computed in bf16,
   TRAIN_STEPS AdamW steps on a seeded TRAIN_B x TRAIN_S batch, each
   logged with its loss, grad norm, ms and tokens/s, and the peak GiB
   allocated; the losses finite and falling. "train 8b": the
   Llama-3.1-8B shape at two layers (no CUDA kernel of the port is on its
   path: the einsum attention, float projections); save_train_state at
   the last step (GB and seconds written and read), latest_checkpoint
   its step_N, one more step, then a fresh template restored from the
   checkpoint takes the same step (loss within TRAIN_RESUME_REL, every
   weight after it within TRAIN_RESUME_ATOL of the uninterrupted run's:
   the AdamW moments and step count restored); the restored weights quantized int8 and served through LocalLLM for
   TRAIN_SERVE_TOKENS greedy tokens ("train serve": #8, #3); the
   directory deleted. "train moe": Mixtral-8x7B's shape at one layer,
   moe_grouped="on": each expert projection's forward and dx through #12's
   stack kernel over the f32 stacks (variants w=f32 and dx w=f32: dx reads
   the stacks as they lie), dw through csrc/moe_wgrad.cu
   (moe_grouped_wgrad), the aux loss at least 1 - 1e-5, the router
   moved. Then the
   grouped GEMM's backward (ops/moe_matmul.GroupedKernelPath) at those
   shapes against autograd through its plain version, within BWD_TOL,
   with its times beside the plain ones and torch._grouped_mm's on bf16
   stacks (the kernels line's "moe_grouped_stack w=f32" row).

Each LLM call of phases 4-5 and 7-8 is timed on its own, and a line after
each phase gives the script's seconds so far. Each of the
thirty-six runs resets the kernels' launch counts just before its
requests and reads them just after; every kernel of that run's path
(PATH_KERNELS) and every instantiation it must reach (PATH_VARIANTS) must
have launched.

Prints a JSON line with the kernels' results, the clocks read before
and after phase 3, the checkpoint writes and loads, and phases 4i's, 4j's
and 9's readings, then the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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


START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(done: str) -> None:
    """The script's seconds so far, after the phase ``done``."""
    log(f"elapsed: {time.perf_counter() - START:.1f} s after {done}")


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


def ptxas_of(build_log: str, kernel: str) -> str:
    """nvcc's -Xptxas -v report of the kernel whose mangled name holds
    `kernel`: its registers and spills, or "not built here" when the library
    was loaded from an earlier build."""
    fn, found = "?", {}
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif kernel in fn and ("registers" in line or "spill" in line):
            found.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return "; ".join(sorted({part for parts in found.values() for part in parts})) \
        or "not built here"


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

TOPK_D = 384
# (b, corpus columns, k) at which #1 and #2 are timed, d = TOPK_D
TOPK_SHAPES = {
    "S1": (1, N_DOCS, 20),     # the smoke /chat corpus
    "S2": (1, 1 << 20, 20),    # a million-chunk corpus: 805 MB in bf16, 403 MB in int8
    "S3": (256, 65536, 10),    # the JAX package's retrieval benchmark (bench.py)
}
TOPK_NEAR_TIE = 1e-5  # #1 at S2 and S3: ids may swap only between plain scores this close
TOPK_NEAR_TIE_F64 = 1e-6  # ... and against the f64 order only between dots this close


def topk_corpus(gen, n_cols: int, d: int = TOPK_D):
    """Unit rows (n_cols, d) with exact duplicates of row 50 (rows 100-109,
    a pair straddling the first 128-column tile's end and a pair straddling
    the corpus's middle: the lowest index must win the ties wherever they
    fall) and an additive mask with a padding tail and 500 dead columns."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    c = torch.randn(n_cols, d, generator=gen, device="cuda")
    c = c / c.norm(dim=1, keepdim=True)
    c[100:110] = c[50]
    c[[127, 128, n_cols // 2 - 1, n_cols // 2]] = c[50].clone()
    mask = torch.zeros(1, n_cols, device="cuda")
    mask[0, n_cols - 300:] = topk.NEG_INF                 # padding tail
    mask[0, torch.randperm(n_cols - 300, generator=gen, device="cuda")[:500]] = topk.NEG_INF
    return c, mask


def topk_index(gen, kind: str, n_cols: int):
    """Row 50 of a topk_corpus, its mask, and the index #1 (bf16 columns)
    or #2 (int8 codes and per-column scales, as the int8 index stores
    them) scores."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    c, mask = topk_corpus(gen, n_cols)
    if kind == "bf16":
        corpus, c_scale = c.T.contiguous().to(torch.bfloat16), None
    else:
        codes, scales = topk.quantize_int8(c, axis=1)
        corpus, c_scale = codes.T.contiguous(), scales.T.contiguous()
    return c[50].clone(), mask, corpus, c_scale


def topk_calls(kind: str, corpus, c_scale):
    """(kernel, plain) as functions of (queries, k, mask), the kernel's
    with a `merge` route keyword (None: the plan's)."""
    from ragmeup_tpu_torch.ops import topk
    if kind == "int8":
        def kernel(q, k, m, merge=None):
            if merge is None:
                return topk.dense_topk_int8(q, corpus, c_scale, k, mask=m)
            return topk._dense_topk_int8_cuda(q, corpus, c_scale, k, m, merge)
        return kernel, lambda q, k, m: topk.dense_topk_int8_plain(q, corpus, c_scale, k, mask=m)

    def kernel(q, k, m, merge=None):
        if merge is None:
            return topk.dense_topk(q, corpus, k, mask=m)
        return topk._dense_topk_cuda(q, corpus, k, m, merge)
    return kernel, lambda q, k, m: topk.dense_topk_plain(q, corpus, k, mask=m)


def topk_compare(what: str, q, corpus, mask, got, want, near_ties: bool) -> tuple:
    """(largest score difference, near-tie swaps) of a kernel's (scores,
    ids) against the plain version's. Ids must be equal. With `near_ties`
    a rank's id x may differ from the plain version's y only in a near-tie:
    both columns live, their plain scores within TOPK_NEAR_TIE (two columns
    whose f32 sums, taken in another order, swap), and their dots in f64
    either in the kernel's order of x and y (x first unless y stands
    earlier in the kernel's list) or within TOPK_NEAR_TIE_F64 of each
    other; each row's ids stay distinct. The first swaps are logged with
    both columns' plain scores and f64 dots. Any other difference raises."""
    import torch
    (s1, i1), (s0, i0) = got, want
    err = (s0 - s1).abs().max().item()
    bad = i0 != i1
    if not bad.any():
        return err, 0
    r, j = bad.nonzero()[0].tolist()
    first = (f"first at row {r} rank {j}: {i1[r, j].item()} ({s1[r, j].item()!r}) for "
             f"{i0[r, j].item()} ({s0[r, j].item()!r})")
    if not near_ties or int(bad.sum()) > 64:
        raise AssertionError(f"{what}: {int(bad.sum())} ids differ, {first}")
    qc = q.to(corpus.dtype)
    far, logged = 0, 0
    for r, j in bad.nonzero().tolist():
        x, y = int(i1[r, j]), int(i0[r, j])
        listed = i1[r].tolist()
        x_first = y not in listed or j < listed.index(y)
        cols = [x, y] if min(x, y) >= 0 else [0, 0]
        plain = (qc[r:r + 1].float() @ corpus[:, cols].float() + mask[:, cols])[0].tolist()
        exact = (qc[r].double() @ corpus[:, cols].double()).tolist()
        live = min(x, y) >= 0 and bool((mask[0, cols] == 0).all())
        ex, ey = exact if x_first else exact[::-1]
        ix, iy = (x, y) if x_first else (y, x)
        in_order = ex > ey or (ex == ey and ix < iy)
        near = (live and abs(plain[0] - plain[1]) <= TOPK_NEAR_TIE
                and (in_order or abs(ex - ey) <= TOPK_NEAR_TIE_F64))
        far += not near
        if logged < 4 or not near:
            logged += 1
            log(f"  {what}: row {r} rank {j}: kernel {x} for plain {y} "
                f"({'near-tie' if near else 'NOT a near-tie'}); plain scores {plain}, "
                f"f64 dots {exact}, the kernel lists {x if x_first else y} first")
    distinct = bool((i1[bad.any(dim=1)].sort(dim=1).values.diff(dim=1) != 0).all())
    if far or not distinct:
        raise AssertionError(f"{what}: ids differ beyond near-ties ({far} far swaps; ids "
                             f"distinct in each row: {distinct}), {first}")
    return err, int(bad.sum())


def traced(fn) -> list:
    """(name, start_us, end_us) of each device kernel, copy and memset one
    call of `fn` launched (torch.profiler). The profiler first runs a
    warm-up step on a trivial kernel and traces only the next, the call:
    started cold, the device tracing missed a call's first kernels on the
    card (one call's first kernel, another's all). Every traced call
    launches a kernel, so a trace with no device event at all is a miss of
    the tracing and is taken again, up to three times in all (a warm trace
    came back empty once, in a #6 route check)."""
    import torch
    from ragmeup_tpu_torch.tools.decode_profile import _device_intervals
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1)) as prof:
            for step in (lambda: torch.ones(1, device="cuda").add_(1), fn):
                step()
                torch.cuda.synchronize()
                prof.step()
        events = _device_intervals(prof)
        if events:
            break
    return events


def device_events(fn) -> list:
    """traced(fn) after a warm-up call of `fn`."""
    import torch
    fn()
    torch.cuda.synchronize()
    return traced(fn)


def ms_by_kernel(events) -> dict:
    """Device ms of the rk_ kernels among `events`, summed by name."""
    sums = {}
    for name, start, end in events:
        for found in re.findall(r"rk_\w+", name):
            sums[found] = round(sums.get(found, 0.0) + (end - start) / 1e3, 4)
    return sums


def topk_readings(gen, kind: str) -> dict:
    """#1 (kind "bf16") or #2 ("int8") at TOPK_SHAPES against its plain
    version, on both merge routes (topk.MERGE_ROUTES: a second launch, or
    the last block of each row group): at S1 and S2, b in {1, 8} and k in
    {10, 20, 128} with query 0 on row 50's duplicates; at S3, b = 256 and
    k = 10. #2's ids equal and scores equal. #1's scores within 1e-5, ids
    equal at S1 and equal up to near-ties at S2 and S3 (topk_compare: its
    tensor-core sums are taken in another order than cuBLAS's, so two
    columns within about 1e-7 can swap), the swaps counted a shape. At S1
    also eight queries over a corpus with every column masked (k = 20) and
    with 50 live columns (k = 128), ids equal. Times at each shape's (b, k),
    on the plan's route: eager and CUDA-graph ms, the plain version's ms,
    #1's two-call yardstick (a bf16 matmul, then torch.topk, which does not
    promise the lowest index on ties), the device launches of one call, the
    bound, and the clocks after; and each route's graph ms, measured in the
    order launch, last block, last block, launch (`merge_graph_ms`). Each
    shape's index is freed before the next."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    err, shapes = 0.0, {}
    for name, (b_t, n_cols, k_t) in TOPK_SHAPES.items():
        c50, mask, corpus, c_scale = topk_index(gen, kind, n_cols)
        kernel, plain = topk_calls(kind, corpus, c_scale)
        cases = [(b_t, k_t)] if name == "S3" else [(b, k) for b in (1, 8) for k in (10, 20, 128)]
        swaps = 0
        for b, k in cases:
            q = torch.randn(b, TOPK_D, generator=gen, device="cuda")
            q[0] = c50
            want = plain(q, k, mask)
            for merge in topk.MERGE_ROUTES:
                got = kernel(q, k, mask, merge)
                torch.cuda.synchronize()
                e, s = topk_compare(f"{kind} top-k {name} b={b} k={k} merge={merge}", q, corpus,
                                    mask, got, want, near_ties=kind == "bf16" and name != "S1")
                err, swaps = max(err, e), swaps + s
        if name == "S1":
            live50 = torch.full_like(mask, topk.NEG_INF)
            live50[0, torch.randperm(n_cols, generator=gen, device="cuda")[:50]] = 0.0
            for label, m, k in (("every column masked", torch.full_like(mask, topk.NEG_INF), 20),
                                ("50 live columns", live50, 128)):
                q = torch.randn(8, TOPK_D, generator=gen, device="cuda")
                want = plain(q, k, m)
                for merge in topk.MERGE_ROUTES:
                    got = kernel(q, k, m, merge)
                    torch.cuda.synchronize()
                    e, _ = topk_compare(f"{kind} top-k {label} merge={merge}", q, corpus, m, got,
                                        want, False)
                    err = max(err, e)
        q = torch.randn(b_t, TOPK_D, generator=gen, device="cuda")
        run = lambda: kernel(q, k_t, mask)  # noqa: E731
        events = device_events(run)
        routes = {merge: [] for merge in topk.MERGE_ROUTES}
        for merge in (*topk.MERGE_ROUTES, *reversed(topk.MERGE_ROUTES)):
            routes[merge].append(graph_ms_or_none(f"top-k {kind} {name} merge={merge}",
                                                  lambda: kernel(q, k_t, mask, merge)))
        reading = {"b": b_t, "n": n_cols, "k": k_t, "ms": median_ms(run),
                   "graph_ms": graph_ms_or_none(f"top-k {kind} {name}", run),
                   "merge_graph_ms": routes,
                   "plain_ms": median_ms(lambda: plain(q, k_t, mask)),
                   "launches_a_call": len(events), "device_ms": ms_by_kernel(events),
                   **bound(nbytes(q, corpus, mask, *([c_scale] if c_scale is not None else []))
                           + b_t * k_t * 8, 2 * b_t * TOPK_D * n_cols, kind)}
        if kind == "bf16":
            qb = q.to(torch.bfloat16)
            reading["yardstick_ms"] = median_ms(
                lambda: torch.topk((qb @ corpus).float() + mask, k_t))
            reading["near_tie_swaps"] = swaps
        shapes[name] = stamped(reading)
        log(f"  top-k {kind} {name}: {json.dumps(shapes[name])}")
        del corpus, c_scale, mask, kernel, plain, q
        free_card()
    if err > (1e-5 if kind == "bf16" else 0.0):
        raise AssertionError(f"top-k {kind} scores differ by {err}")
    s1 = shapes["S1"]
    return {"max_abs_err": err, "library_ms": None, "shapes": shapes,
            **{key: s1[key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
            "shape": f"b=1 d={TOPK_D} N={N_DOCS} k=20 {kind}"}


def check_topk(gen) -> dict:
    """#1 at TOPK_SHAPES (topk_readings), at most two device launches a
    call, and an f32 corpus (the CUDA-core product) at S1 against its plain
    version within 1e-5, ids equal. No one PyTorch call computes the
    function: library_ms is None, the two-call yardstick is in `shapes`."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    result = topk_readings(gen, "bf16")
    c50, mask, corpus, _ = topk_index(gen, "bf16", N_DOCS)
    corpus = corpus.float()
    q = torch.randn(8, TOPK_D, generator=gen, device="cuda")
    q[0] = c50
    err, _ = topk_compare("f32 top-k S1 b=8 k=20", q, corpus, mask,
                          topk.dense_topk(q, corpus, 20, mask=mask),
                          topk.dense_topk_plain(q, corpus, 20, mask=mask), False)
    if err > 1e-5:
        raise AssertionError(f"f32 top-k scores differ by {err}")
    too_many = {n: r["launches_a_call"] for n, r in result["shapes"].items()
                if r["launches_a_call"] > 2}
    if too_many:
        raise AssertionError(f"top-k bf16 launches more than two kernels a call: {too_many}")
    return dict(result, f32_max_abs_err=err)


def check_topk_int8(gen) -> dict:
    """#2 at TOPK_SHAPES (topk_readings): scores equal to the plain
    version's (the int8 dot is exact and the epilogue rounds in the same
    order), queries quantized inside the kernel, so a call is captured in a
    CUDA graph (graph_ms must be a number) and launches at most two
    kernels."""
    result = topk_readings(gen, "int8")
    for name, r in result["shapes"].items():
        if r["graph_ms"] is None:
            raise AssertionError(f"top-k int8 at {name}: the call was not captured in a graph")
        if r["launches_a_call"] > 2:
            raise AssertionError(f"top-k int8 at {name}: {r['launches_a_call']} launches a call")
    return result


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


def int4pack_ms(calls, group: int, plain) -> tuple:
    """torch._weight_int4pack_mm over `calls` [(x, w, s)] (a layer's
    projections, or each slot's expert of a gather layer) at group `group`:
    the same signed nibbles + 8 packed by torch._convert_weight_to_int4pack,
    bf16 group scales with zero 0, all prepared outside the timing (a
    yardstick: the port never calls it). Returns (ms, error against the
    plain version, refusal, graph ms)."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    try:
        packed = []
        for x, w, s in calls:
            k = 2 * w.shape[0]
            u = (qm.unpack_int4(w, qm.int4_tiling(k)[0]).to(torch.int32) + 8).t().contiguous()
            w_u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            qsz = torch.stack([s.to(torch.bfloat16), torch.zeros_like(s, dtype=torch.bfloat16)],
                              dim=2).contiguous()
            packed.append((x, torch._convert_weight_to_int4pack(w_u8, 8), qsz))
            del u, w_u8

        def run():
            return [torch._weight_int4pack_mm(x, wp, group, qsz) for x, wp, qsz in packed]
        err = max((got.float() - plain(x, w, s).float()).abs().max().item()
                  for got, (x, w, s) in zip(run(), calls))
        return median_ms(run, reps=10), err, None, graph_ms(run, reps=4)
    except Exception as exc:  # the yardstick is optional; its refusal is printed
        refusal = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log(f"  torch._weight_int4pack_mm refused: {refusal}")
        return None, None, refusal, None


def launched_kernels(fn) -> set:
    """Names of the device kernels one call of `fn` launched (traced)."""
    return {name for name, _, _ in traced(fn)}


def kernels_of(fn) -> list:
    """The rk_ kernels a call of `fn` launches (torch.profiler), sorted: the
    union over two traced calls, since a trace on the card has dropped a
    call's first kernel while keeping the rest (#13's mma kernel missing
    beside its reduce). A kernel either call launched is listed."""
    names = launched_kernels(fn) | launched_kernels(fn)
    return sorted({found for name in names for found in re.findall(r"rk_\w+", name)})


def kernels_of_retraced(fn, tries: int = 3) -> list:
    """kernels_of(fn) for a call that launches an rk_ kernel on every
    route, taken again while a trace names none, up to `tries` times: the
    device tracing has missed every rk_ kernel of such a call, both traces
    of it (an MoE layer after the "moe" run had launched #10 18,048 times;
    phase 9's dw and its grouped-rows call over f32 stacks, which the
    launch counts show running)."""
    found = []
    for _ in range(tries):
        found = kernels_of(fn)
        if found:
            break
    return found


def check_int4_decode_short_and_routes(gen) -> dict:
    """#4's decode kernels (m <= 8) where the plan leaves a short last
    slice in every k-tile (k = tile_k = 1040: 520 packed rows a tile in
    slices of 64, the last 8 rows; quality group 130, which crosses the
    warps' runs and takes the scalar kernel, and group 1040, the
    output-scaled route, which bf16 takes to the tensor cores), m in {1, 3,
    8}, bf16 and f32, against the plain version at one bf16 ulp of the
    largest output. Then which kernels launch: W4A16 bf16 at m = 1 and 8
    (group 128) must run rk_int4_decode_mma_kernel, f32 at m = 1 and bf16
    at group 130 rk_int4_decode_kernel, m = 256 rk_int4_partial_kernel,
    each alone beside the reduce."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    k, n = 1040, 512
    ks = qm.int4_decode_plan(1, k, n, k, 130, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    last = qm.int4_decode_slices(k, k, ks)[-1]
    if not last[1] - last[0] < ks:
        raise AssertionError(f"int4 decode: no short slice at k={k} (slice {ks}, last {last})")
    err = 0.0
    short = {}
    for group in (130, 1040):
        w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3
        short[group] = (w, s)
        for dtype in (torch.bfloat16, torch.float32):
            for m in (1, 3, 8):
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                y1 = qm.int4_matmul(x, w, s)
                y0 = qm.int4_matmul_plain(x, w, s)
                torch.cuda.synchronize()
                diff = (y0.float() - y1.float()).abs().max().item()
                tol = 2.0 ** -7 * y0.float().abs().max().item()
                if not diff <= tol:
                    raise AssertionError(f"int4 decode short slice group={group} {dtype} "
                                         f"m={m}: {diff} > {tol}")
                err = max(err, diff)
    k, n = DECODE_SHAPES["q"]
    w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(k // 128, n, generator=gen, device="cuda") * 2e-3 + 1e-3
    cases = {"bf16 m=1": (1, torch.bfloat16, w, s, "rk_int4_decode_mma_kernel"),
             "bf16 m=8": (8, torch.bfloat16, w, s, "rk_int4_decode_mma_kernel"),
             "f32 m=1": (1, torch.float32, w, s, "rk_int4_decode_kernel"),
             "bf16 m=1 group 130": (1, torch.bfloat16, *short[130], "rk_int4_decode_kernel"),
             "bf16 m=256": (256, torch.bfloat16, w, s, "rk_int4_partial_kernel")}
    routes = {}
    for label, (m, dtype, wc, sc, want) in cases.items():
        x = torch.randn(m, 2 * wc.shape[0], generator=gen, device="cuda").to(dtype)
        names = kernels_of(lambda: qm.int4_matmul(x, wc, sc))
        main = [name for name in names if "reduce" not in name]
        if main != [want]:
            raise AssertionError(f"int4_matmul {label} launched {names}, wanted {want}")
        routes[label] = names
    log(f"  int4 decode: short-slice error {err}; kernels: {routes}")
    return {"short_slice_err": err, "kernels_by_call": routes}


def int4_scalar_decode(x, w, s):
    """#4's scalar decode kernel (rk_int4_decode_kernel) on a bf16 call the
    wrapper sends to the tensor cores: the yardstick of that choice, timed
    beside it (the port never makes this call)."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    m, k = x.shape
    n = w.shape[1]
    tile_k, group = qm.int4_tiling(k)[0], k // s.shape[0]
    ks = qm.int4_decode_plan(m, k, n, tile_k, group, kernels.sm_count(x.device.index))
    slices = len(qm.int4_decode_slices(k, tile_k, ks))
    partial = torch.empty((slices, m, n) if slices > 1 else (0,), device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    kernels.check(kernels.lib().rk_int4_decode(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), m, k, n, tile_k, group, ks,
        kernels.dtype_code(x.dtype), 0, partial.data_ptr(), out.data_ptr(),
        kernels.stream_handle(x.device)), "int4 scalar decode")
    return out


def int4_quantize_rows(x):
    """#5's first kernel alone (rk_quantize_rows_kernel, through its own C
    entry): x's int8 codes and row scales. A check and timing call; the
    port never makes it."""
    import torch
    from ragmeup_tpu_torch import kernels
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty(m, device=x.device)
    kernels.check(kernels.lib().rk_quantize_rows(
        x.data_ptr(), m, k, kernels.dtype_code(x.dtype), xq.data_ptr(), xs.data_ptr(),
        kernels.stream_handle(x.device)), "quantize rows")
    return xq, xs


def device_ms_by_kernel(fn) -> dict:
    """Device ms of the rk_ kernels one call of `fn` launched, summed by
    kernel name (torch.profiler): where a layer's time goes."""
    return ms_by_kernel(device_events(fn))


def check_int4_a8_decode_short_and_routes(gen) -> dict:
    """#5's decode kernel (m <= 8) where its plan leaves a short last slice
    in the k-tile (k = tile_k = 2144: 67 k-blocks of 16 packed rows, which
    no longer slice divides; n = 14336), m in {1, 3, 8}, bf16 and f32,
    equal to the plain version; the quantizer's codes and scales equal to
    quantize_int8's at the 8B widths; then which kernels launch: m = 1 and
    8 rk_int4_a8_decode_kernel, m = 256 and m = 3 at k = 1040 (whose half
    tile is no whole number of k-blocks; equal to the plain version)
    rk_int4_a8_partial_kernel, each beside the quantizer and the reduce."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    from ragmeup_tpu_torch.ops.topk import quantize_int8
    k, n = 2144, 14336
    ks = qm.int4_a8_decode_plan(1, k, n, k, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    last = qm.int4_decode_slices(k, k, ks)[-1]
    if not last[1] - last[0] < ks:
        raise AssertionError(f"int4 a8 decode: no short slice at k={k} (slice {ks}, last {last})")
    short = {"k": k, "n": n, "k_slice": ks, "last": last, "equal": True}
    w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(1, n, generator=gen, device="cuda") * 2e-3 + 1e-3
    for dtype in (torch.bfloat16, torch.float32):
        for m in (1, 3, 8):
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            if not torch.equal(qm.int4_matmul(x, w, s, a8=True), qm.int4_matmul_a8_plain(x, w, s)):
                raise AssertionError(f"int4 a8 decode short slice {dtype} m={m}: not equal")
            for kq in (4096, 14336):
                xk = torch.randn(m, kq, generator=gen, device="cuda").to(dtype)
                got, want = int4_quantize_rows(xk), quantize_int8(xk.float(), axis=1)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1][:, 0])):
                    raise AssertionError(f"quantize rows {dtype} m={m} k={kq}: not equal")
    k, n = DECODE_SHAPES["q"]
    w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand(k // 512, n, generator=gen, device="cuda") * 2e-3 + 1e-3
    # k = tile_k = 1040: 520 packed rows a tile, no whole k-blocks, so m <= 8
    # takes the 8-row kernel
    w1040 = torch.randint(-128, 128, (520, 512), generator=gen, device="cuda", dtype=torch.int8)
    s1040 = torch.rand(1, 512, generator=gen, device="cuda") * 2e-3 + 1e-3
    routes = {}
    for m, want, wc, sc in ((1, "rk_int4_a8_decode_kernel", w, s),
                            (8, "rk_int4_a8_decode_kernel", w, s),
                            (256, "rk_int4_a8_partial_kernel", w, s),
                            (3, "rk_int4_a8_partial_kernel", w1040, s1040)):
        x = torch.randn(m, 2 * wc.shape[0], generator=gen, device="cuda").to(torch.bfloat16)
        if m <= 8 and not torch.equal(qm.int4_matmul(x, wc, sc, a8=True),
                                      qm.int4_matmul_a8_plain(x, wc, sc)):
            raise AssertionError(f"int4_matmul_a8 m={m} k={x.shape[1]}: not equal")
        names = kernels_of(lambda: qm.int4_matmul(x, wc, sc, a8=True))
        main = [name for name in names if "reduce" not in name and "quantize" not in name]
        if main != [want]:
            raise AssertionError(f"int4_matmul_a8 m={m} launched {names}, wanted {want}")
        routes[f"bf16 m={m} k={x.shape[1]}"] = names
    log(f"  int4 a8 decode: short slice ({ks} packed rows, last {last}) and quantizer exact; "
        f"kernels: {routes}")
    return {"short_slice": short, "kernels_by_call": routes}


def check_int4(gen, a8: bool) -> dict:
    """#4 (W4A16, groups 128 and 512: the quality and the output-scaled
    route) or #5 (W4A8, group 512) at the 8B projection shapes, bf16, on
    random packed bytes and scales, at m in {1, 2, 3, 4, 8, 256} (m <= 8
    is the decode kernel); #4 also with f32 activations at m <= 8.
    Tolerance: one bf16 ulp of the largest output (2^-7 * max |ref|): both
    versions sum in f32 and round once; #5 at m <= 8 equal to the plain
    version (exact integer sums, the same epilogue order). Times: the 7
    projections of one layer in sequence (109 MB of packed int4, beyond
    the 50 MB L2, as decode reads it) at m = 1, 8 and 256, eager, and from
    a CUDA graph's replay; #5 also its quantizer's 7 launches alone in a
    graph (int4_quantize_rows), the layer's device time by kernel
    (device_ms_by_kernel), and its short-slice, quantizer and launch checks
    (check_int4_a8_decode_short_and_routes); #4 beside its library yardstick
    torch._weight_int4pack_mm over the group-128 layer at m = 1 and 8
    (int4pack_ms) and its scalar decode kernel on the same bf16 calls
    (int4_scalar_decode, checked at the same tolerance), and its
    short-slice and launch checks (check_int4_decode_short_and_routes)."""
    import torch
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    plain = qm.int4_matmul_a8_plain if a8 else qm.int4_matmul_plain

    def kernel(x, w, s):
        return qm.int4_matmul(x, w, s, a8=a8)
    err, f32_err, times, moved, graph, library, scalar = 0.0, 0.0, {}, {}, {}, {}, {}
    quant, by_kernel = {}, {}
    checked = (1, 2, 3, 4, 8, 256)
    for group in (512,) if a8 else (128, 512):
        weights = {}
        for name, (k, n) in DECODE_SHAPES.items():
            w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.int8)
            s = torch.rand(k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3
            weights[name] = (w, s)
            if name in ("v", "o", "up"):
                continue  # same (k, n) as a projection checked already
            cases = [(m, torch.bfloat16) for m in checked]
            if not a8:
                cases += [(m, torch.float32) for m in checked if m <= 8]
            for m, dtype in cases:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                y1 = kernel(x, w, s)
                y0 = plain(x, w, s)
                torch.cuda.synchronize()
                diff = (y0.float() - y1.float()).abs().max().item()
                tol = 2.0 ** -7 * y0.float().abs().max().item()
                if not diff <= tol or (a8 and m <= 8 and not torch.equal(y0, y1)):
                    raise AssertionError(f"int4 a8={a8} group={group} {name} m={m} "
                                         f"{dtype}: {diff} > {tol} or not equal")
                if dtype == torch.float32:
                    f32_err = max(f32_err, diff)
                else:
                    err = max(err, diff)
        moved[group] = sum(nbytes(w, s) + 2 * (2 * w.shape[0] + w.shape[1])
                           for w, s in weights.values())
        for m in (1, 8, 256):
            xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k in (4096, 14336)}

            def layer(fn, xs=xs, weights=weights):
                return lambda: [fn(xs[2 * w.shape[0]], w, s) for w, s in weights.values()]
            reps = 10 if m <= 8 else 2
            times[f"group{group}_m{m}"] = (median_ms(layer(kernel), reps=reps),
                                           median_ms(layer(plain), reps=reps))
            graph[f"group{group}_m{m}"] = graph_ms(layer(kernel), reps=4 if m <= 8 else 2)
            if a8 and m <= 8:
                quant[m] = graph_ms(lambda xs=xs, weights=weights: [
                    int4_quantize_rows(xs[2 * w.shape[0]]) for w, _ in weights.values()], reps=4)
                by_kernel[m] = device_ms_by_kernel(layer(kernel))
                log(f"  int4_matmul_a8 layer m={m}: graph {graph[f'group512_m{m}']} ms, its "
                    f"quantizer's 7 launches alone {quant[m]} ms; device ms by kernel "
                    f"{by_kernel[m]}")
            if not a8 and group == 128 and m <= 8:
                for w, s in weights.values():
                    y0 = plain(xs[2 * w.shape[0]], w, s)
                    diff = (y0.float() - int4_scalar_decode(xs[2 * w.shape[0]], w, s).float()
                            ).abs().max().item()
                    if not diff <= 2.0 ** -7 * y0.float().abs().max().item():
                        raise AssertionError(f"int4 scalar decode m={m}: {diff}")
                scalar[m] = graph_ms(layer(int4_scalar_decode), reps=4)
                library[m] = int4pack_ms([(xs[2 * w.shape[0]], w, s)
                                          for w, s in weights.values()], group, plain)
                log(f"  int4_matmul library yardstick torch._weight_int4pack_mm (group 128, "
                    f"m={m}): {library[m][0]} ms (graph {library[m][3]}), error against the "
                    f"plain version {library[m][1]}; the kernel's layer {times[f'group128_m{m}'][0]}"
                    f" ms, in a graph {graph[f'group128_m{m}']} ms (scalar kernel {scalar[m]})")
    main = "group512_m1" if a8 else "group128_m1"
    ms, plain_ms = times[main]
    ops = sum(2 * (2 * k) * n for k, n in
              ((w.shape[0], w.shape[1]) for w, _ in weights.values()))
    m8_bound = bound(moved[512 if a8 else 128] + sum(2 * 7 * (2 * w.shape[0] + w.shape[1])
                                                     for w, _ in weights.values()),
                     8 * ops, "int8" if a8 else "bf16")
    # W4A8: no one PyTorch call
    lib = {"library_ms": None, "library_graph_ms": None,
           "m8": {"ms": times["group512_m8"][0], "graph_ms": graph["group512_m8"], **m8_bound},
           "quantize_graph_ms": quant,
           "quantize_share": {m: round(quant[m] / graph[f"group512_m{m}"], 4) for m in quant},
           "device_ms_by_kernel": by_kernel,
           **check_int4_a8_decode_short_and_routes(gen)} if a8 else {}
    if not a8:
        lib = {"library_ms": library[1][0], "library_graph_ms": library[1][3],
               "library_call": "torch._weight_int4pack_mm",
               "library_err": library[1][1], "library_refusal": library[1][2],
               "f32_max_abs_err": f32_err,
               "scalar_kernel_graph_ms": scalar,
               "m8": {"ms": times["group128_m8"][0], "graph_ms": graph["group128_m8"],
                      "library_ms": library[8][0], "library_graph_ms": library[8][3],
                      **m8_bound},
               **check_int4_decode_short_and_routes(gen)}
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph[main], "plain_ms": plain_ms,
            **lib, **bound(moved[512 if a8 else 128], ops, "int8" if a8 else "bf16"),
            "shape": f"one decode layer: 7 projections at m=1, bf16, group "
                     f"{512 if a8 else 128}",
            "layer_graph_ms": {key: round(t, 4) for key, t in graph.items()},
            "layer_ms_kernel_plain": {key: [round(a, 4), round(b, 4)]
                                      for key, (a, b) in times.items()}}


def flash_inputs(gen, bkv, g, s, kv_len, dtype=None, hd=128):
    """q (bkv, g, s, hd), k and v (bkv, kv_len, hd), N(0, 1) on the card."""
    import torch
    dtype = dtype or torch.bfloat16
    q = torch.randn(bkv, g, s, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(bkv, kv_len, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(bkv, kv_len, hd, generator=gen, device="cuda").to(dtype)
    return q, k, v


def flash_held(what, q, k, v, sm_scale=None) -> float:
    """One call of #8 against its plain version (2e-2 absolute, see
    check_flash); the call must launch the kernel, counted under its
    head dim and group."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import attention
    key = f"flash_gqa hd={q.shape[3]} g={q.shape[1]}"
    before = kernels.launch_counts()["flash_gqa"], kernels.variant_counts().get(key, 0)
    o1 = attention.flash_attention_gqa(q, k, v, sm_scale=sm_scale)
    after = kernels.launch_counts()["flash_gqa"], kernels.variant_counts().get(key, 0)
    if after[0] == before[0] or after[1] == before[1]:
        raise AssertionError(f"flash_attention_gqa {what}: the kernel did not launch")
    o0 = attention.flash_attention_gqa_plain(q, k, v, sm_scale=sm_scale)
    torch.cuda.synchronize()
    err = (o0.float() - o1.float()).abs().max().item()
    if not (err <= 2e-2 and torch.isfinite(o1).all()):
        raise AssertionError(f"flash_attention_gqa {what} differs by {err}")
    return err


def flash_timed(q, k, v) -> dict:
    """#8's eager and graph ms, its plain version's and SDPA's (eager, and in
    a CUDA graph: library_graph_ms), and the bound. Causal: the function
    reads keys 0..s-1 only; 4 flops per (query, key) pair and head dim (two
    products)."""
    import torch
    from ragmeup_tpu_torch.ops import attention
    bkv, g, s, hd = q.shape
    pairs = bkv * g * s * (s + 1) // 2
    kq, vq = k[:, None, :s], v[:, None, :s]
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, kq, vq, is_causal=True,
                                                                enable_gqa=True)
    return {"ms": median_ms(lambda: attention.flash_attention_gqa(q, k, v), reps=5),
            "graph_ms": graph_ms_or_none("flash_gqa", lambda: attention.flash_attention_gqa(
                q, k, v), reps=5),
            "plain_ms": median_ms(lambda: attention.flash_attention_gqa_plain(q, k, v),
                                  reps=5),
            "library_ms": median_ms(sdpa, reps=5),
            "library_graph_ms": graph_ms_or_none("scaled_dot_product_attention", sdpa, reps=5),
            **bound(2 * nbytes(q) + nbytes(kq, vq), 4 * pairs * hd, "bf16")}


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
    main = flash_inputs(gen, 8, 4, 1024, 2048)
    err = flash_held("g=4 s=1024", *main)
    g1 = flash_inputs(gen, 32, 1, 1024, 2048)
    err = max(err, flash_held("g=1 s=1024", *g1))
    for g, bkv in ((4, 2), (1, 8)):
        err = max(err, flash_held(f"ragged g={g} s=200 kv_len=256",
                                  *flash_inputs(gen, bkv, g, 200, 256)))
    f32_err = flash_held("f32 g=4 s=200", *flash_inputs(gen, 2, 4, 200, 256, torch.float32))
    s256 = flash_inputs(gen, 8, 4, 256, 2048)
    err = max(err, flash_held("g=4 s=256", *s256))
    return {"max_abs_err": err, **flash_timed(*main),
            "shape": "bkv=8 g=4 s=1024 kv_len=2048 hd=128 bf16",
            "g1_bkv32_s1024": flash_timed(*g1), "g4_s256": flash_timed(*s256),
            "f32_err": f32_err}


# (label, head_dim, query heads, kv heads) of the checkpoint families whose
# shapes #8 and #9 take beyond hd 128 with a power-of-two group
FAMILY_SHAPES = {"Gemma-7B": (256, 16, 16), "Gemma-2-9B": (256, 16, 8),
                 "Qwen2.5-7B": (128, 28, 4), "Qwen2.5-0.5B": (64, 14, 2),
                 "Phi-3-mini": (96, 32, 32)}


def check_flash_families(gen) -> dict:
    """#8 at Gemma-7B's prefill (hd 256, g 1: 16 kv heads, s 1024, kv_len
    2048), Gemma-2-9B's (hd 256, g 2) and Qwen2.5-7B's (hd 128, g 7: 9
    positions of 7 heads a block, 63 of its 64 rows); each also ragged (s
    200, kv_len 256) and in f32 at a small shape; Gemma-2's scale
    (query_pre_attn_scalar 256: 1/16). Tolerance as check_flash. Rows: hd
    256 (timed at Gemma-7B's shape, Gemma-2-9B's beside it, with the wgmma
    kernel's ptxas report) and g 7."""
    import torch
    rows = {}
    for row, labels in (("hd=256", ("Gemma-7B", "Gemma-2-9B")), ("g=7", ("Qwen2.5-7B",))):
        err, f32_err, timed = 0.0, 0.0, {}
        for label in labels:
            hd, nh, nkv = FAMILY_SHAPES[label]
            g = nh // nkv
            main = flash_inputs(gen, nkv, g, 1024, 2048, hd=hd)
            err = max(err, flash_held(f"{label} hd={hd} g={g} s=1024", *main),
                      flash_held(f"{label} ragged s=200 kv_len=256",
                                 *flash_inputs(gen, nkv, g, 200, 256, hd=hd)),
                      flash_held(f"{label} scale 1/16", *main, sm_scale=1 / 16))
            f32_err = max(f32_err, flash_held(
                f"{label} f32 s=200", *flash_inputs(gen, 2, g, 200, 256, torch.float32, hd)))
            timed[label] = dict(flash_timed(*main),
                                shape=f"bkv={nkv} g={g} s=1024 kv_len=2048 hd={hd} bf16")
            log(f"  flash_gqa {label}: {json.dumps(timed[label])}")
        first = timed[labels[0]]
        rows[row] = dict(first, max_abs_err=err, f32_err=f32_err,
                         **{label: timed[label] for label in labels[1:]})
    from ragmeup_tpu_torch import kernels
    rows["hd=256"]["ptxas"] = ptxas_of(kernels.build_log, "rk_flash_gqa_wgmma_kernel")
    return rows


def paged_inputs(gen, b: int, lengths, q_len: int, nh: int = 32, nkv: int = 8,
                 P: int = 512, ps: int = 128, mp: int = 16, hd: int = 128):
    """q (b, q_len, nh, hd) and a bf16 pool (nkv, P, ps, hd), at the 8B
    serving shapes by default; each sequence's mp-page table holds distinct
    pages scattered over the pool (entries past its length too, which the
    kernel must not read)."""
    import torch
    q = torch.randn(b, q_len, nh, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(nkv, P, ps, hd, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(nkv, P, ps, hd, generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randperm(P, generator=gen, device="cuda")[:b * mp].reshape(b, mp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, idx.to(torch.int32), lens


def paged_off(out, ref):
    """|out - ref| and where it exceeds two bf16 ulps of the row's largest
    |ref| (0 for an all-zero row) or is not finite."""
    import torch
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    big = ref.abs().amax(-1, keepdim=True)
    tol = 2.0 * torch.exp2(torch.floor(torch.log2(big)) - 7)
    return err, (err > tol) | ~torch.isfinite(out)


def paged_compare(name, out, ref) -> float:
    import torch
    torch.cuda.synchronize()
    err, bad = paged_off(out, ref)
    if bad.any():
        at = tuple(bad.nonzero()[0].tolist())
        raise AssertionError(
            f"{name} differs from its plain version at {at} by "
            f"{err[at].item()}, beyond two bf16 ulps of its row's largest output")
    return err.max().item()


def paged_case(gen, label, b, lengths, q_len, nh=32, nkv=8, hd=128, ps=128, mp=16,
               timed=False, pads=0, **kw):
    """One check of #9 against its plain version (the call must launch the
    kernel, counted under its head dim and group); with `timed`, the
    kernel's eager and graph times, the plain version's, the bound and the
    split count. The last `pads` rows are a spec wave's pad rows: a table of
    page 0 but for one trash page first, shared by them all. Returns (result,
    inputs)."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import paged_attention as pa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q, k, v, idx, lens = paged_inputs(gen, b, lengths, q_len, nh=nh, nkv=nkv, ps=ps, mp=mp,
                                      P=max(512, b * mp), hd=hd)
    if pads:
        trash = idx[b - 1, 0].item()
        idx[b - pads:] = 0
        idx[b - pads:, 0] = trash
    if q_len == 1:
        q = q[:, 0].contiguous()
        fn, plain = pa.paged_attention, pa.paged_attention_plain
    else:
        fn, plain = pa.paged_attention_chunk, pa.paged_attention_chunk_plain
    name = f"{fn.__name__} {label}"
    key = f"{fn.__name__} hd={hd} g={nh // nkv}"
    before = kernels.variant_counts().get(key, 0)
    out = fn(q, k, v, idx, lens, **kw)
    if kernels.variant_counts().get(key, 0) == before:
        raise AssertionError(f"{name}: the kernel did not launch")
    err = paged_compare(name, out, plain(q, k, v, idx, lens, **kw))
    splits = pa.paged_splits(mp, ps, pa.kernel_split(b, q_len, nh, nkv, ps, mp,
                                                     torch.bfloat16, sms, hd))
    res = {"max_abs_err": err, "splits": splits}
    if timed:
        # K/V rows read once per kv head; 4 flops per (query row, key, dim)
        pairs = sum(q_len * (n - q_len) + q_len * (q_len + 1) // 2 for n in lengths)
        res.update(ms=median_ms(lambda: fn(q, k, v, idx, lens, **kw)),
                   graph_ms=graph_ms(lambda: fn(q, k, v, idx, lens, **kw)),
                   plain_ms=median_ms(lambda: plain(q, k, v, idx, lens, **kw), reps=5),
                   **bound(2 * sum(lengths) * nkv * hd * 2 + 2 * nbytes(q) + nbytes(idx, lens),
                           4 * pairs * nh * hd, "bf16"))
        log(f"  {name}: {res['ms']:.4f} ms, graph {res['graph_ms']:.4f} (plain "
            f"{res['plain_ms']:.4f}, bound {res['bound_ms']:.4f}), {splits} splits")
    return res, (q, k, v, idx, lens)


def check_paged(gen) -> dict:
    """#9 in both modes at the 8B serving shapes (nh 32, nkv 8, hd 128, bf16;
    128-token pages, 16-page tables over a 512-page pool unless stated).
    Decode: 8 sequences of 1 to 2048 tokens; one of 2048; four of 1024 to
    2048 (the batched run's shape). Chunk-append: a 128-token chunk for 1
    and for 4 sequences after prefixes of 0 to 1920 tokens; the spec waves'
    8-token chunk for 4 sequences after 300 to 2040 tokens, and for 8 rows
    of which 4 are pad rows (length 8 on a shared trash page). Both modes also
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

    def case(*args, **kw):
        return paged_case(gen, *args, **kw)

    lengths = [1, 2048, 777, 128, 129, 1500, 64, 1024]
    decode, (qd, k, v, idx, lens) = case("b=8", 8, lengths, 1, timed=True)
    # the tolerance must catch a kernel that drops each long sequence's tail page
    ref = pa.paged_attention_plain(qd, k, v, idx, lens)
    cut = torch.tensor([n - ((n - 1) % 128 + 1) if n > 128 else n for n in lengths],
                       dtype=torch.int32, device="cuda")
    caught = paged_off(pa.paged_attention_plain(qd, k, v, idx, cut), ref)[1].flatten(1).any(1)
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
    # the spec waves' shape: 8-token chunks, 32 query rows in a 64-row tile
    spec = [300, 777, 1500, 2040]
    chunk["q8"] = case("q_len=8 b=4", 4, [p + 8 for p in spec], 8, timed=True)[0]
    chunk["q8"]["prefixes"] = spec
    chunk["q8 pads"] = case("q_len=8 b=8, 4 pad rows", 8,
                            [p + 8 for p in spec] + [8] * 4, 8, pads=4)[0]
    log(f"  paged_attention_chunk q_len=8 b=8 with 4 pad rows: error "
        f"{chunk['q8 pads']['max_abs_err']}, {chunk['q8 pads']['splits']} splits")
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
                                                 chunk[4]["max_abs_err"],
                                                 chunk["q8"]["max_abs_err"],
                                                 chunk["q8 pads"]["max_abs_err"], err),
                       library_ms=None,
                       shape="q_len=128 b=4 nh=32 nkv=8 hd=128 ps=128 bf16",
                       b1=chunk[1], q8=chunk["q8"], q8_pads=chunk["q8 pads"])
    return {"decode": decode, "chunk": chunk_entry}


def replays_equal(gen, b: int, lengths, nh: int, nkv: int, hd: int, q_len: int = 1,
                  **kw) -> bool:
    """One call of #9 (decode, or chunk-append where q_len > 1) captured in a
    CUDA graph and replayed twice: the two outputs equal bit for bit (the
    splits merge in split order)."""
    import torch
    from ragmeup_tpu_torch.ops import paged_attention as pa
    q, k, v, idx, lens = paged_inputs(gen, b, lengths, q_len, nh=nh, nkv=nkv, hd=hd)
    fn = pa.paged_attention if q_len == 1 else pa.paged_attention_chunk
    if q_len == 1:
        q = q[:, 0].contiguous()
    out = torch.empty_like(q)
    fn(q, k, v, idx, lens, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out.copy_(fn(q, k, v, idx, lens, **kw))
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(first, out))


# the kernel of #9 each mode takes at each head dim (csrc/paged_attention.cu)
PAGED_ROUTES = {("paged_attention", 64): "rk_paged_decode_narrow_kernel",
                ("paged_attention", 96): "rk_paged_decode_narrow_kernel",
                ("paged_attention", 128): "rk_paged_decode_kernel",
                ("paged_attention", 256): "rk_paged_decode_mma_kernel",
                ("paged_attention_chunk", 64): "rk_paged_chunk_kernel",
                ("paged_attention_chunk", 96): "rk_paged_chunk_kernel",
                ("paged_attention_chunk", 128): "rk_paged_chunk_kernel",
                ("paged_attention_chunk", 256): "rk_paged_chunk_wgmma_kernel"}
# the query heads and kv heads at which the hd-64/96 decode kernel is also
# held, so that it is checked at g 1, 2, 7 and 8 at both head dims
NARROW_GROUPS = {64: ((14, 14), (14, 7), (16, 2)), 96: ((32, 16), (28, 4), (32, 4))}


def check_paged_families(gen) -> dict:
    """#9 at the families' head dims and groups (FAMILY_SHAPES): hd 64
    (Qwen2.5-0.5B, 14/2 heads), hd 96 (Phi-3-mini, 32/32), hd 256
    (Gemma-2-9B, 16/8) and g 7 (Qwen2.5-7B, 28/4 heads at hd 128). Each in
    decode (8 sequences of 1 to 2048 tokens) and chunk mode (a 128-token
    chunk for 4 sequences after 0 to 1920 tokens), timed, and each again
    with a window below the context (512 over 2048 tokens), softcap 50 and
    sm_scale 1/16 together; Gemma-2-9B also over 16-token pages, its chunk
    over 24-token pages (no TMA box fits: the kernel's cp.async route), and
    its chunk also at the spec waves' q_len 8 (4 sequences after 300 to 2,040
    tokens, timed; 8 rows of which 4 are pad rows of length 8 on a shared
    trash page), both over 16-token pages with the window, softcap and
    scale. The hd-64/96 decode kernel is also held at the other groups of
    g 1, 2, 7 and 8 (NARROW_GROUPS). Tolerance as check_paged. The hd-256
    rows also read two replays of one captured call (`replays_equal`, bit
    for bit), and the hd-256 and hd-64/96 rows their kernel's ptxas report.
    Each row names the kernels its call launched (torch.profiler), which
    must hold the kernel PAGED_ROUTES gives its mode and head dim. Returns
    {"paged_attention hd=64": ..., ...}, one entry a kernel mode and shape."""
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import paged_attention as pa
    lengths = [1, 2048, 777, 128, 129, 1500, 64, 1024]
    chunk_lengths = [p + 128 for p in (0, 640, 1333, 1920)]
    spec = [300, 777, 1500, 2040]
    gemma2 = {"window": 512, "softcap": 50.0, "sm_scale": 1 / 16}
    rows = {}
    for row, label in (("hd=64", "Qwen2.5-0.5B"), ("hd=96", "Phi-3-mini"),
                       ("hd=256", "Gemma-2-9B"), ("g=7", "Qwen2.5-7B")):
        hd, nh, nkv = FAMILY_SHAPES[label]
        shape = dict(nh=nh, nkv=nkv, hd=hd)
        for mode, b, lens, q_len in (("paged_attention", 8, lengths, 1),
                                     ("paged_attention_chunk", 4, chunk_lengths, 128)):
            tag = f"{label} hd={hd} g={nh // nkv} b={b}"
            res, (q, k, v, idx, lens_t) = paged_case(gen, tag, b, lens, q_len, timed=True,
                                                     **shape)
            fn = getattr(pa, mode)
            want = PAGED_ROUTES[(mode, hd)]
            res["kernels"] = kernels_of_retraced(lambda: fn(q, k, v, idx, lens_t))
            if want not in res["kernels"]:
                raise AssertionError(f"{mode} {tag} launched {res['kernels']}, not {want}")
            extra = {"window+softcap+scale": paged_case(
                gen, f"{tag} window=512 softcap=50 sm_scale=1/16", b, lens, q_len,
                **shape, **gemma2)[0]}
            if hd == 256:
                extra["ps=16"] = paged_case(gen, f"{tag} ps=16", b, lens, q_len, ps=16,
                                            mp=128, **shape, **gemma2)[0]
                res.update(replays_equal=replays_equal(gen, b, lens, q_len=q_len, **shape),
                           ptxas=ptxas_of(kernels.build_log, want))
                if not res["replays_equal"]:
                    raise AssertionError(f"{mode} {tag}: two replays of one call differ")
            if hd == 256 and q_len > 1:
                # a page size no TMA box fits: the producer's cp.async route
                extra["ps=24"] = paged_case(gen, f"{tag} ps=24", b, lens, q_len, ps=24, mp=86,
                                            **shape, **gemma2)[0]
                res["q8"] = paged_case(gen, f"{label} q_len=8 b=4 ps=16", 4,
                                       [p + 8 for p in spec], 8, ps=16, mp=128, timed=True,
                                       **shape, **gemma2)[0]
                res["q8"]["prefixes"] = spec
                extra["q8 pads"] = paged_case(gen, f"{label} q_len=8 b=8, 4 pad rows, ps=16", 8,
                                              [p + 8 for p in spec] + [8] * 4, 8, ps=16, mp=128,
                                              pads=4, **shape, **gemma2)[0]
            if hd in (64, 96) and q_len == 1:
                res["ptxas"] = ptxas_of(kernels.build_log, want)
                for gnh, gnkv in NARROW_GROUPS[hd]:
                    extra[f"g={gnh // gnkv}"] = paged_case(
                        gen, f"{label}-shaped hd={hd} {gnh}/{gnkv} heads", b, lens, q_len,
                        nh=gnh, nkv=gnkv, hd=hd, **gemma2)[0]
            rows[f"{mode} {row}"] = dict(
                res, max_abs_err=max([res["max_abs_err"]]
                                     + [r["max_abs_err"] for r in extra.values()]
                                     + ([res["q8"]["max_abs_err"]] if "q8" in res else [])),
                library_ms=None, variants=extra,
                shape=f"{label}: b={b} q_len={q_len} nh={nh} nkv={nkv} hd={hd} ps=128 bf16")
            log(f"  {mode} {row}: kernels {res['kernels']}, variants (error, splits) "
                + json.dumps({key: [r["max_abs_err"], r["splits"]] for key, r in extra.items()}))
    return rows


# Mixtral-8x7B's expert projections: (k, n) of gate, up and down
MOE_E = 8
# phases 7 and 8 draw the random Mixtral decoders at this many of its 32
# layers (full width): the script's time limit
MOE_SMOKE_LAYERS = 16
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
    14336 x 4096), S in {2, 16} slots, bf16, and at S = 2 with both slots
    on one expert (a slot's block offsets the weights by its own id: shared
    experts hide a wrong base); float experts at a smaller shape (bf16
    experts with bf16 x, f32 experts with f32 x); Qwen3-30B-A3B's int8
    experts (E 128; gate/up 2048 x 768, down 768 x 2048: multiples of 128,
    not of 512) at its 8 decode slots. Tolerance: moe_compare. One launch a
    call (the launch counter), and a CUDA graph of the split-K call (its
    strips' last blocks elected by ticket words the call leaves zeroed)
    replayed twice: both replays equal the eager output bit for bit. Times:
    one decode layer's three projections at S = 2 (two routed experts, 352
    MB of int8: beyond the 50 MB L2), and Qwen3-30B-A3B's at S = 8
    ("qwen3_30b_a3b": 38 MB)."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    weights = {name: moe_experts(gen, MOE_E, k, n, "int8")
               for name, (k, n) in MOE_SHAPES.items()}
    err = 0.0
    for slots, shared in ((2, False), (16, False), (2, True)):
        ids = torch.randint(0, MOE_E, (slots,), generator=gen, device="cuda")
        ids[:2] = torch.tensor([5, 5] if shared else [5, 2])
        for name in ("gate", "down"):
            w, s = weights[name]
            x = torch.randn(slots, w.shape[1], generator=gen, device="cuda").to(torch.bfloat16)
            before = kernels.launch_counts()["moe_gather"]
            got = mm.moe_gather_matmul(x, w, ids, s)
            if kernels.launch_counts()["moe_gather"] != before + 1:
                raise AssertionError(f"moe_gather {name} S={slots}: not one launch a call")
            err = max(err, moe_compare(f"moe_gather {name} S={slots} ids {ids.tolist()}", got,
                                       mm.moe_gather_matmul_plain(x, w, ids, s)))
            if name == "down" and shared:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    replayed = mm.moe_gather_matmul(x, w, ids, s)
                outs = []
                for _ in range(2):
                    graph.replay()
                    torch.cuda.synchronize()
                    outs.append(replayed.clone())
                if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], got)):
                    raise AssertionError("moe_gather: CUDA-graph replays differ from each "
                                         "other or from the eager call")
                del graph
    for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        w, _ = moe_experts(gen, MOE_E, 1024, 2048, kind)
        x = torch.randn(16, 1024, generator=gen, device="cuda").to(dtype)
        ids = torch.randint(0, MOE_E, (16,), generator=gen, device="cuda")
        moe_compare(f"moe_gather {kind} experts", mm.moe_gather_matmul(x, w, ids),
                    mm.moe_gather_matmul_plain(x, w, ids))
    qwen = {name: moe_experts(gen, 128, k, n, "int8")
            for name, (k, n) in (("gate", (2048, 768)), ("up", (2048, 768)),
                                 ("down", (768, 2048)))}
    qids = torch.randperm(128, generator=gen, device="cuda")[:8]
    qxs = {k: torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
           for k in (2048, 768)}
    for name in ("gate", "down"):
        w, s = qwen[name]
        err = max(err, moe_compare(f"moe_gather Qwen3-30B-A3B {name} S=8",
                                   mm.moe_gather_matmul(qxs[w.shape[1]], w, qids, s),
                                   mm.moe_gather_matmul_plain(qxs[w.shape[1]], w, qids, s)))

    def timed(weights, xs, ids):
        slots = len(ids)

        def layer(fn):
            return lambda: [fn(xs[w.shape[1]], w, ids, s) for w, s in weights.values()]
        moved = sum(slots * (w.shape[1] * w.shape[2] + 4 * w.shape[2])
                    + nbytes(xs[w.shape[1]]) + 2 * slots * w.shape[2]
                    for w, _ in weights.values())
        ops = sum(2 * slots * w.shape[1] * w.shape[2] for w, _ in weights.values())
        return {"ms": median_ms(layer(mm.moe_gather_matmul), reps=10),
                "graph_ms": graph_ms_or_none("moe_gather", layer(mm.moe_gather_matmul), reps=4),
                "plain_ms": median_ms(layer(mm.moe_gather_matmul_plain), reps=2),
                **bound(moved, ops, "bf16")}
    xs = {k: torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
          for k in (4096, 14336)}
    qwen_times = timed(qwen, qxs, qids)
    log(f"  moe_gather Qwen3-30B-A3B layer at S=8: {json.dumps(qwen_times)}")
    return {"max_abs_err": err, **timed(weights, xs, torch.tensor([5, 2], device="cuda")),
            "library_ms": None,  # no one PyTorch call gathers experts and multiplies
            "shape": "one Mixtral decode layer: gate, up, down at S=2 slots (experts 5, 2), "
                     "int8 experts, bf16",
            "qwen3_30b_a3b": dict(qwen_times, shape="one Qwen3-30B-A3B decode layer: gate, "
                                  "up, down at S=8 slots, int8 experts, bf16")}


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


# the kernel each grouped route launches (torch.profiler names)
GROUPED_KERNELS = {("moe_grouped", "bf16"): "rk_moe_grouped_mma_kernel",
                   ("moe_grouped_stack", "bf16"): "rk_moe_stack_wgmma_kernel",
                   ("moe_grouped", "f32"): "rk_moe_grouped_f32_kernel",
                   ("moe_grouped_stack", "f32"): "rk_moe_grouped_f32_kernel"}


def check_moe_grouped(gen) -> dict:
    """#11 on the dedup route (16 slots sorted by expert, expert 2 with no
    rows, no_stack; and 32 rows with a group of 17, three 8-row tiles of
    one expert over two passes) and #12 on the full-stack route (a prefill
    chunk of 1032 rows over all 8 experts, 128-row tiles; and a second set
    of 1032 rows with an empty group, a one-row group and exact multiples
    of 128), at Mixtral's int8 expert shapes, bf16; both routes also with
    bf16 experts and with f32 experts and activations at a smaller shape,
    and #12 at k = 1152 (18 k-steps, not a whole number of rings); #11's
    kernel split over k (down at 512 columns: 5 slices, the strips' last
    blocks adding them) and a CUDA graph of that call replayed twice, both
    replays equal to the eager call bit for bit. Held to the plain version
    of the whole grouped product (no padded layout) with moe_compare; each
    call must launch its route's kernel once (GROUPED_KERNELS, from the
    profiler; the launch counter). Times: one layer's three projections on
    each route (the whole function), and each route's kernel alone
    (kernel_ms, and kernel_graph_ms from a CUDA graph): #11's grouped-rows
    kernel on the sorted rows, #12's on the padded layout scatter_layout
    gives. #11 is also timed over bf16 experts (the row "moe_grouped
    w=bf16"), beside torch._grouped_mm on the same stacks, which computes
    the same function there (its library_ms). Bounds count the experts
    this data routes to and its real rows."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    weights = {name: moe_experts(gen, MOE_E, k, n, "int8")
               for name, (k, n) in MOE_SHAPES.items()}
    stack_sets = [torch.tensor([100, 180, 90, 150, 120, 132, 160, 100]),
                  torch.tensor([128, 0, 1, 255, 17, 384, 130, 117])]
    routes = {"moe_grouped": ([torch.tensor([3, 2, 0, 4, 1, 2, 3, 1]),
                               torch.tensor([3, 2, 0, 17, 1, 2, 3, 4])],
                              dict(tm=16, tile_k=2048, tile_n=1024, no_stack=True)),
              "moe_grouped_stack": (stack_sets, {})}

    def launched(name, kind, fn):
        """fn's output, after checking it launched the route's kernel once
        a call (kernels_of traces two calls, and a trace that came back
        empty is taken again: the calls are counted)."""
        calls = []

        def counted():
            calls.append(1)
            return fn()
        before = kernels.launch_counts()[name]
        found = kernels_of(counted)
        launches = kernels.launch_counts()[name] - before
        if launches != len(calls) or found != [GROUPED_KERNELS[name, kind]]:
            raise AssertionError(f"{name} {kind}: launched {found} ({launches} launches "
                                 f"in {len(calls)} calls), not {GROUPED_KERNELS[name, kind]}")
        return fn()

    out = {}
    for name, (group_sets, kw) in routes.items():
        err = 0.0
        for gsz in group_sets:
            gsz = gsz.cuda()
            m = int(gsz.sum())
            xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k in (4096, 14336)}
            for proj in ("gate", "down"):
                w, s = weights[proj]
                got = launched(name, "bf16", lambda: mm.moe_grouped_matmul(xs[w.shape[1]], w,
                                                                            gsz, s, **kw))
                err = max(err, moe_compare(f"{name} {proj} groups {gsz.tolist()}", got,
                                           mm.moe_grouped_matmul_plain(xs[w.shape[1]], w, gsz,
                                                                       s)))
        gsz = group_sets[0].cuda()
        m = int(gsz.sum())
        for kind, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            w, _ = moe_experts(gen, MOE_E, 1024, 2048, kind)
            x = torch.randn(m, 1024, generator=gen, device="cuda").to(dtype)
            fkw = dict(kw, tm=8) if kw and dtype == torch.float32 else kw
            got = launched(name, "bf16" if dtype == torch.bfloat16 else "f32",
                           lambda: mm.moe_grouped_matmul(x, w, gsz, **fkw))
            moe_compare(f"{name} {kind} experts", got, mm.moe_grouped_matmul_plain(x, w, gsz))
        if name == "moe_grouped":
            # split-K on the card: 512 columns of down leave 32 (strip, expert)
            # blocks, so k is cut and each strip's last block adds the slices
            # (ticket words); a CUDA graph of the call replayed twice
            w, s = moe_experts(gen, MOE_E, 14336, 512, "int8")
            x = torch.randn(m, 14336, generator=gen, device="cuda").to(torch.bfloat16)
            slices = len(mm.grouped_rows_slices(14336, mm.grouped_rows_plan(
                m, MOE_E, 14336, 512, w.dtype, kernels.sm_count(0))))
            if slices < 2:
                raise AssertionError(f"{name}: the split-K check cut k into {slices} slice")
            got = launched(name, "bf16", lambda: mm.grouped_rows(x, w, s, gsz))
            moe_compare(f"{name} split-K ({slices} slices)", got,
                        mm.moe_grouped_matmul_plain(x, w, gsz, s))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = mm.grouped_rows(x, w, s, gsz)
            outs = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                outs.append(replayed.clone())
            if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], got)):
                raise AssertionError(f"{name}: CUDA-graph replays differ from each other or "
                                     "from the eager call")
            del graph, w, x
        if name == "moe_grouped_stack":
            w, s = moe_experts(gen, MOE_E, 1152, 2048, "int8")
            x = torch.randn(m, 1152, generator=gen, device="cuda").to(torch.bfloat16)
            moe_compare(f"{name} k 1152", launched(name, "bf16", lambda: mm.moe_grouped_matmul(
                x, w, gsz, s, tile_k=128)), mm.moe_grouped_matmul_plain(x, w, gsz, s))
        xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 14336)}

        def layer(fn, kw=kw):
            return lambda: [fn(xs[w.shape[1]], w, gsz, s, **kw) for w, s in weights.values()]
        used = int((gsz > 0).sum())
        moved = sum(used * (w.shape[1] * w.shape[2] + 4 * w.shape[2])
                    + nbytes(xs[w.shape[1]]) + 2 * m * w.shape[2] for w, _ in weights.values())
        ops = sum(2 * m * w.shape[1] * w.shape[2] for w, _ in weights.values())
        # the kernel alone: #11's on the sorted rows, #12's on the padded
        # layout the function hands it
        tm = kw.get("tm", 128)
        stack = name == "moe_grouped_stack"
        if stack:
            padded = {k: mm.scatter_layout(x, gsz, tm, MOE_E) for k, x in xs.items()}
            rows = {k: mm.tile_rows(gsz, p[2], tm) for k, p in padded.items()}

            def alone():
                for w, s in weights.values():
                    xp, _, texp, used_rows = padded[w.shape[1]]
                    mm.grouped_padded(xp, w, s, texp, used_rows, tm, stack=True,
                                      rows=rows[w.shape[1]])
        else:
            def alone():
                for w, s in weights.values():
                    mm.grouped_rows(xs[w.shape[1]], w, s, gsz)
        before = kernels.launch_counts()[name]
        alone()
        if kernels.launch_counts()[name] != before + len(weights):
            raise AssertionError(f"{name}: the kernel's own calls took another route")
        kernel_alone = {"kernel_ms": median_ms(alone, reps=5),
                        "kernel_graph_ms": graph_ms_or_none(f"{name} kernel", alone, reps=4)}
        if stack:
            del padded
        out[name] = {
            **kernel_alone,
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
        if not stack:
            out["moe_grouped w=bf16"] = grouped_bf16_experts(gen, xs, gsz, kw, m, used)
    return out


def grouped_bf16_experts(gen, xs, gsz, kw, m: int, used: int) -> dict:
    """#11 over bf16 Mixtral experts (2.8 GB of stacks) on the dedup
    route: held to the plain version, the function and the kernel alone
    timed, and torch._grouped_mm on the same bf16 stacks (column-major
    copies, made outside the timing), which computes the same function:
    each bf16 weight times bf16 rows, f32 sums, one rounding."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    weights = {name: moe_experts(gen, MOE_E, k, n, "bfloat16")
               for name, (k, n) in MOE_SHAPES.items()}
    err = 0.0
    for w, _ in weights.values():
        before = kernels.launch_counts()["moe_grouped"]
        got = mm.moe_grouped_matmul(xs[w.shape[1]], w, gsz, None, **kw)
        if kernels.launch_counts()["moe_grouped"] != before + 1:
            raise AssertionError("moe_grouped bf16 experts: not one launch a call")
        err = max(err, moe_compare("moe_grouped bf16 experts", got,
                                   mm.moe_grouped_matmul_plain(xs[w.shape[1]], w, gsz)))

    def layer(fn):
        return lambda: [fn(xs[w.shape[1]], w, gsz, None, **kw) for w, _ in weights.values()]
    moved = sum(used * w.shape[1] * w.shape[2] * 2 + nbytes(xs[w.shape[1]])
                + 2 * m * w.shape[2] for w, _ in weights.values())
    ops = sum(2 * m * w.shape[1] * w.shape[2] for w, _ in weights.values())
    library = library_graph = None
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gsz, 0).to(torch.int32)
        stacks = [w.transpose(1, 2).contiguous().transpose(1, 2) for w, _ in weights.values()]
        try:
            def run():
                return [torch._grouped_mm(xs[w.shape[1]], w, offs=offs) for w in stacks]
            moe_compare("torch._grouped_mm bf16 experts", run()[2],
                        mm.moe_grouped_matmul_plain(xs[stacks[2].shape[1]],
                                                    weights["down"][0], gsz))
            library = median_ms(run, reps=5)
            library_graph = graph_ms_or_none("torch._grouped_mm", run, reps=4)
        except Exception as exc:  # the yardstick is optional; its refusal is logged
            log(f"  torch._grouped_mm refused: {str(exc).splitlines()[0][:120]}")
        del stacks
    r = {"max_abs_err": err,
         "ms": median_ms(layer(mm.moe_grouped_matmul), reps=5),
         "graph_ms": graph_ms_or_none("moe_grouped bf16 experts",
                                      layer(mm.moe_grouped_matmul), reps=4),
         "kernel_ms": median_ms(lambda: [mm.grouped_rows(xs[w.shape[1]], w, None, gsz)
                                         for w, _ in weights.values()], reps=5),
         "kernel_graph_ms": graph_ms_or_none("moe_grouped bf16 experts kernel", lambda: [
             mm.grouped_rows(xs[w.shape[1]], w, None, gsz) for w, _ in weights.values()],
             reps=4),
         "plain_ms": median_ms(layer(lambda x, w, g, s, **_: mm.moe_grouped_matmul_plain(
             x, w, g, s)), reps=2),
         "library_ms": library, "library_graph_ms": library_graph,
         **bound(moved, ops, "bf16"),
         "shape": f"one Mixtral layer: gate, up, down over {m} rows sorted by expert, "
                  f"group sizes {gsz.tolist()}, bf16 experts, bf16"}
    del weights
    return r


def int4_experts(gen, e: int, k: int, n: int, group: int):
    """Packed int4 experts (E, k/2, n) of random bytes (every byte is two
    valid nibbles) with group scales (E, k/group, n) of 1e-3 to 3e-3."""
    import torch
    return (torch.randint(-128, 128, (e, k // 2, n), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(e, k // group, n, generator=gen, device="cuda") * 2e-3 + 1e-3)


def check_moe_gather_int4(gen) -> dict:
    """#13 at Mixtral's expert shapes (E 8; gate/up 4096 x 14336, down
    14336 x 4096), bf16, for group 128 (weights dequantized and rounded)
    and group 512 (the k-tile: the output-scaled route), on 2 slots with
    distinct experts (5, 2), 2 slots on one expert (3, 3) and 16 slots
    (experts repeated); f32 activations at a smaller shape (16 slots); k =
    tile_k = 1040 (3 slots, groups 130 and 1040, bf16 and f32), where the
    plan's last slice of the k-tile is short; n = 768, which the 512-column
    strips do not tile (the older kernel). Tolerance: moe_compare; the
    kernel scales each split-K slice's partial before the slices are added
    (output-scaled route) and adds the slices in order, one more f32
    rounding than the plain version's per-tile sums, far inside one bf16
    ulp. Each checked call must take the kernel route, and a torch.profiler
    trace shows that each route launched the kernel it names (bf16 groups
    128, 512 and 1040 rk_moe_gather_int4_mma_kernel, f32 and group 130
    rk_moe_gather_int4_decode_kernel, n = 768
    rk_moe_gather_int4_partial_kernel), with the reduce where the plan cuts
    k into slices. Times: one decode layer's three projections at S = 2
    (experts 5 and 2) at groups 128 (187 MB routed: beyond the 50 MB L2)
    and 512, eager and from a CUDA graph; the bound counts the two routed
    experts' bytes. Beside them, a yardstick that is not one call and so
    not a library call of the same function: torch._weight_int4pack_mm on
    each slot's expert (6 calls a layer, group 128, int4pack_ms)."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    from ragmeup_tpu_torch.ops import quant_matmul as qm

    def launched(what, *args):
        before = kernels.launch_counts()["moe_gather_int4"]
        got = mm.moe_gather_matmul_int4(*args)
        if kernels.launch_counts()["moe_gather_int4"] == before:
            raise AssertionError(f"moe_gather_int4 {what}: the call took another route")
        return got

    def route(what, want, slices, *args):
        names = kernels_of(lambda: mm.moe_gather_matmul_int4(*args))
        wanted = sorted([want] + ["rk_moe_gather_int4_reduce_kernel"] * (slices > 1))
        if names != wanted:
            raise AssertionError(f"moe_gather_int4 {what} launched {names}, wanted {wanted}")
        return names
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ids = torch.tensor([5, 2], device="cuda")
    many = torch.randint(0, MOE_E, (16,), generator=gen, device="cuda")
    many[:4] = torch.tensor([5, 2, 5, 2])
    slot_ids = {"distinct": ids, "repeated": torch.tensor([3, 3], device="cuda"),
                "16 slots": many}
    xs = {label: {k: torch.randn(len(i), k, generator=gen, device="cuda").to(torch.bfloat16)
                  for k in (4096, 14336)} for label, i in slot_ids.items()}
    err, times, graphs, routes = 0.0, {}, {}, {}
    for group in (128, 512):
        weights = {name: int4_experts(gen, MOE_E, k, n, group)
                   for name, (k, n) in MOE_SHAPES.items()}
        for label, sid in slot_ids.items():
            for name, (w, s) in weights.items():
                if label == "16 slots" and name == "up":
                    continue  # gate's shape
                x = xs[label][2 * w.shape[1]]
                what = f"{name} group {group} {label}"
                err = max(err, moe_compare(f"moe_gather_int4 {what}",
                                           launched(what, x, w, s, sid, 512, group),
                                           mm.moe_gather_matmul_int4_plain(x, w, s, sid, 512,
                                                                           group)))
        w, s = weights["gate"]
        k, n = MOE_SHAPES["gate"]
        routes[f"bf16 group {group}"] = route(
            f"bf16 group {group}", "rk_moe_gather_int4_mma_kernel",
            len(qm.int4_decode_slices(k, 512, mm.int4_gather_plan(2, k, n, 512, group, sms))),
            xs["distinct"][k], w, s, ids, 512, group)

        def layer(fn, weights=weights, group=group):
            return lambda: [fn(xs["distinct"][2 * w.shape[1]], w, s, ids, 512, group)
                            for w, s in weights.values()]
        times[group] = (median_ms(layer(mm.moe_gather_matmul_int4), reps=10),
                        median_ms(layer(mm.moe_gather_matmul_int4_plain), reps=2))
        graphs[group] = graph_ms_or_none(f"moe_gather_int4 group {group}",
                                         layer(mm.moe_gather_matmul_int4), reps=4)
        if group == 128:
            moved = sum(2 * nbytes(w[0], s[0]) + nbytes(xs["distinct"][2 * w.shape[1]])
                        + 2 * 2 * w.shape[2] for w, s in weights.values())
            ops = sum(2 * 2 * 2 * w.shape[1] * w.shape[2] for w, _ in weights.values())
            slices = {name: len(qm.int4_decode_slices(k, 512, mm.int4_gather_plan(
                2, k, n, 512, group, sms))) for name, (k, n) in MOE_SHAPES.items()}
            library = int4pack_ms(
                [(xs["distinct"][2 * w.shape[1]][i:i + 1], w[e], s[e])
                 for w, s in weights.values() for i, e in enumerate(ids.tolist())],
                group, qm.int4_matmul_plain)
            log(f"  moe_gather_int4 yardstick torch._weight_int4pack_mm on each slot's expert "
                f"(6 calls, group 128; not one call, not a library call of the same "
                f"function): {library[0]} ms (graph {library[3]}), error against the plain "
                f"version {library[1]}; the kernel's layer {times[128][0]} ms, graph "
                f"{graphs[128]} ms, split-K slices {slices}")
        del weights
    for group in (128, 512):
        w, s = int4_experts(gen, MOE_E, 1024, 2048, group)
        x = torch.randn(16, 1024, generator=gen, device="cuda")
        sid = torch.randint(0, MOE_E, (16,), generator=gen, device="cuda")
        moe_compare(f"moe_gather_int4 f32 group {group}",
                    launched(f"f32 group {group}", x, w, s, sid, 512, group),
                    mm.moe_gather_matmul_int4_plain(x, w, s, sid, 512, group))
        if group == 128:
            routes["f32 group 128"] = route(
                "f32 group 128", "rk_moe_gather_int4_decode_kernel",
                len(qm.int4_decode_slices(1024, 512, mm.int4_gather_plan(
                    16, 1024, 2048, 512, group, sms))), x, w, s, sid, 512, group)
    # k = tile_k = 1040: 520 packed rows a tile, the last slice short
    k, n = 1040, 512
    sid = torch.tensor([4, 1, 4], device="cuda")
    for group, kernel in ((130, "rk_moe_gather_int4_decode_kernel"),
                          (1040, "rk_moe_gather_int4_mma_kernel")):
        ks = mm.int4_gather_plan(3, k, n, k, group, sms)
        ranges = qm.int4_decode_slices(k, k, ks)
        if not ranges[-1][1] - ranges[-1][0] < ks:
            raise AssertionError(f"moe_gather_int4: no short slice at k={k} (slice {ks})")
        w, s = int4_experts(gen, MOE_E, k, n, group)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(3, k, generator=gen, device="cuda").to(dtype)
            what = f"k {k} group {group} {dtype}"
            err = max(err, moe_compare(f"moe_gather_int4 {what}", launched(
                what, x, w, s, sid, k, group),
                mm.moe_gather_matmul_int4_plain(x, w, s, sid, k, group)))
            want = kernel if dtype == torch.bfloat16 else "rk_moe_gather_int4_decode_kernel"
            routes[what] = route(what, want, len(ranges), x, w, s, sid, k, group)
    # n = 768: the JAX gate admits it (an n tile of 256), the strips do not
    w, s = int4_experts(gen, MOE_E, 1024, 768, 128)
    x = torch.randn(3, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    err = max(err, moe_compare("moe_gather_int4 n 768", launched("n 768", x, w, s, sid, 512, 128),
                               mm.moe_gather_matmul_int4_plain(x, w, s, sid, 512, 128)))
    routes["n 768"] = route("n 768", "rk_moe_gather_int4_partial_kernel", 2,  # always reduces
                            x, w, s, sid, 512, 128)
    log(f"  moe_gather_int4 kernels by call: {routes}")
    return {"max_abs_err": err, "ms": times[128][0], "graph_ms": graphs[128],
            "plain_ms": times[128][1],
            "library_ms": None,  # no one PyTorch call gathers int4 experts and multiplies
            "int4pack_per_slot_yardstick": {
                "ms": library[0], "graph_ms": library[3], "err": library[1],
                "refusal": library[2],
                "calls": "torch._weight_int4pack_mm on each slot's expert, 6 a layer: not one "
                         "call, not a rule-1 library call"},
            **bound(moved, ops, "bf16"),
            "shape": "one Mixtral decode layer: gate, up, down at S=2 slots (experts 5, 2), "
                     "packed int4 experts, group 128, bf16",
            "slices": slices, "kernels_by_call": routes,
            "group512": {"ms": times[512][0], "graph_ms": graphs[512],
                         "plain_ms": times[512][1]}}


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
    """#6 against its plain version at the Llama-3.1-8B MLP shape (h 4096,
    I 14336, group 128) in bf16 at m = 1, 2, 3 and 8, and at h 512, I 1024
    in bf16 and f32 at m = 3, on random packed bytes and scales. Tolerance:
    one bf16 ulp of the largest output (both versions sum in f32 and round
    at the same three places; a normalised input or act value may round the
    other way, far inside it); f32 1e-5 of it. Each call is made twice and
    must repeat bit for bit (the slices' partials are added in a fixed
    order, no float atomics), and launch the plan's kernels: bf16 on the
    tensor cores, two launches at m = 1 (each strip's last block sums it),
    four at m > 1 (reduce launches); f32 the two scalar kernels. Times at m =
    1 and 8 (93.5 MB of packed weights and scales, beyond the 50 MB L2):
    eager and from a CUDA graph, each route in a graph, the device ms of
    each kernel, and the yardstick, the port's unfused int4 MLP (RMSNorm,
    #4 for gate, up and down, silu * u, the residual add) in a graph. The
    parent commit's #6 is timed by tools/mlp_int4_times.py in the same
    chip call."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import quant_matmul as qm
    from ragmeup_tpu_torch.tools.mlp_int4_times import mlp_weights, unfused_mlp_int4

    want_kernels = {
        "last_block": ["rk_mlp4_down_mma_kernel", "rk_mlp4_gate_up_mma_kernel"],
        "reduce": ["rk_mlp4_down_mma_kernel", "rk_mlp4_down_reduce_kernel",
                   "rk_mlp4_gate_up_mma_kernel", "rk_mlp4_gate_up_reduce_kernel"],
        "scalar": ["rk_mlp4_down_kernel", "rk_mlp4_gate_up_kernel"]}

    def held(what, x, nw, ws) -> tuple:
        h, inter = x.shape[1], ws[0].shape[1]
        plan = qm.fused_mlp_int4_plan(x.shape[0], h, inter, 512, 128, 512, 128, x.dtype,
                                      kernels.sm_count(0))
        got, again = qm.fused_mlp_int4(x, nw, *ws), qm.fused_mlp_int4(x, nw, *ws)
        err = moe_compare(f"fused_mlp_int4 {what}", got, qm.fused_mlp_int4_plain(x, nw, *ws))
        if not torch.equal(got, again):
            raise AssertionError(f"fused_mlp_int4 {what}: a second call differs")
        events = device_events(lambda: qm.fused_mlp_int4(x, nw, *ws))
        names = sorted(found for name, _, _ in events for found in re.findall(r"rk_\w+", name))
        if names != want_kernels[plan.route] or len(events) != len(names):
            raise AssertionError(f"fused_mlp_int4 {what}: plan {tuple(plan)} launched "
                                 f"{[name for name, _, _ in events]}")
        log(f"  fused_mlp_int4 {what}: error {err}, plan {tuple(plan)}, {len(events)} launches, "
            f"repeats equal")
        return err, plan, events

    h, inter = 4096, 14336
    ws = mlp_weights(gen, h, inter)
    nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    err, shapes = 0.0, {}
    for m in (1, 2, 3, 8):
        x = torch.randn(m, h, generator=gen, device="cuda").to(torch.bfloat16)
        e, plan, events = held(f"m={m}", x, nw, ws)
        err = max(err, e)
        if m not in (1, 8):
            continue
        call = lambda: qm.fused_mlp_int4(x, nw, *ws)  # noqa: E731
        routes = {route: graph_ms_or_none(
            f"fused_mlp_int4 m={m} {route}",
            lambda: qm._fused_mlp_int4_cuda(x, nw, *ws, 1e-5, 512, plan=plan._replace(route=route)))
            for route in ("last_block", "reduce")}
        shapes[f"m={m}"] = stamped({
            "plan": tuple(plan), "launches_a_call": len(events),
            "device_ms": ms_by_kernel(events), "ms": median_ms(call, reps=10),
            "graph_ms": graph_ms_or_none(f"fused_mlp_int4 m={m}", call),
            "route_graph_ms": routes,
            "yardstick_graph_ms": graph_ms_or_none(
                f"unfused int4 MLP m={m}", lambda: unfused_mlp_int4(qm, x, nw, *ws)),
            **bound(nbytes(*ws, nw) + 2 * nbytes(x), 2 * 3 * m * h * inter, "bf16")})
        log(f"  fused_mlp_int4 m={m}: {json.dumps(shapes[f'm={m}'])}")
    small = mlp_weights(gen, 512, 1024)
    nw3 = 1.0 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    x3 = torch.randn(3, 512, generator=gen, device="cuda")
    err = max(err, held("h=512 I=1024 m=3 bf16", x3.to(torch.bfloat16), nw3, small)[0])
    held("h=512 I=1024 m=3 f32", x3, nw3, small)
    x = torch.randn(1, h, generator=gen, device="cuda").to(torch.bfloat16)
    m1 = shapes["m=1"]
    return {"max_abs_err": err, "shapes": shapes,
            **{key: m1[key] for key in ("ms", "graph_ms", "bound_ms", "bound_by")},
            "plain_ms": median_ms(lambda: qm.fused_mlp_int4_plain(x, nw, *ws), reps=2),
            "library_ms": None,  # no one PyTorch call runs the fused int4 MLP
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


def build_llm(seed: int, cfg):
    """The decoder of ``cfg`` (Llama-3.1-8B's or Mixtral-8x7B's shape),
    weights drawn and quantized on the card; decode checked against
    prefill."""
    import torch
    from ragmeup_tpu_torch.models.decoder import LocalLLM, init_decoder_params
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    t0 = time.perf_counter()
    llm_cfg = select_kernels(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_decoder_params(llm_cfg, gen, "cuda")
    eos = (2,) if llm_cfg.num_experts else (128001, 128009)
    llm = LocalLLM(llm_cfg, SimpleTokenizer(llm_cfg.vocab_size), params=params,
                   eos_ids=eos, device="cuda")
    torch.cuda.synchronize()
    log(f"decoder {'Mixtral-8x7B-shaped ' if llm_cfg.num_experts else 'Llama-3.1-8B-shaped '}"
        f"{llm_cfg.quantization}{' W4A8' if llm_cfg.int4_w4a8 else ''} "
        f"built on the card in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    if llm_cfg.num_experts:
        cos, flips, note = check_moe_decoder(llm)
        log(f"  decode step vs prefill logits cosine {cos:.5f}; the last token's "
            f"experts differ in {len(flips)} of {llm_cfg.num_layers} layers {flips}"
            + (f"; {note}" if note else ""))
    else:
        log(f"  decode step vs prefill logits cosine {check_decoder(llm):.5f}")
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
                "default random": ("topk", "int8_matmul", "flash_gqa"),
                "int4 W4A16": ("topk_int8", "int4_matmul", "flash_gqa"),
                "int4 W4A8": ("topk_int8", "int4_matmul_a8", "flash_gqa"),
                "batched": ("topk", "int8_matmul", "paged_attention",
                            "paged_attention_chunk"),
                "greedy": ("topk", "int8_matmul", "flash_gqa"),
                "greedy batched": ("topk", "int8_matmul", "paged_attention_chunk"),
                "http": ("topk", "int8_matmul", "flash_gqa"),
                "http batched": ("topk", "int8_matmul", "paged_attention",
                                 "paged_attention_chunk"),
                "corpus sharded": ("topk", "int8_matmul", "flash_gqa"),
                "ivf": ("int8_matmul", "flash_gqa"),
                "moe": ("topk", "int8_matmul", "flash_gqa", "moe_gather"),
                "moe grouped": ("moe_grouped_stack", "moe_gather"),
                "moe batched": ("paged_attention", "paged_attention_chunk",
                                "moe_grouped"),
                "moe int4": ("topk", "int4_matmul", "flash_gqa", "moe_gather_int4"),
                "moe int4 batched": ("paged_attention", "paged_attention_chunk",
                                     "moe_grouped_int4"),
                "moe int4 W4A8": ("topk", "int4_matmul_a8", "moe_gather_int4"),
                "moe checkpoint int8": ("moe_gather",),
                "moe checkpoint int4": ("moe_gather_int4",),
                "gemma2": ("topk", "int8_matmul"),
                "gemma2 batched": ("topk", "int8_matmul", "paged_attention",
                                   "paged_attention_chunk"),
                "gemma checkpoint int8": ("int8_matmul", "flash_gqa", "paged_attention",
                                          "paged_attention_chunk"),
                "phi3 checkpoint int8": ("int8_matmul", "paged_attention",
                                         "paged_attention_chunk"),
                "phi3 checkpoint int4": ("int4_matmul", "paged_attention",
                                         "paged_attention_chunk"),
                "qwen2 checkpoint int8": ("int8_matmul", "flash_gqa", "paged_attention",
                                          "paged_attention_chunk"),
                "qwen3_moe checkpoint int8": ("flash_gqa", "moe_gather"),
                "qwen3_moe checkpoint int4": ("flash_gqa", "moe_gather_int4"),
                "tp4": ("topk", "int8_matmul", "flash_gqa"),
                "tp4 batched": ("topk", "int8_matmul", "paged_attention",
                                "paged_attention_chunk"),
                "ring": ("topk", "int8_matmul"),
                "moe ep int8": ("int8_matmul", "moe_gather"),
                "moe ep int4": ("int4_matmul", "moe_gather_int4"),
                "tp4 w4a16": ("topk", "int4_matmul", "flash_gqa"),
                "train 8b": (),
                "train moe": ("moe_grouped_stack", "moe_grouped_wgrad"),
                "train serve": ("int8_matmul", "flash_gqa")}
# the kernel instantiations (head dim, group) each run must launch
PATH_VARIANTS = {"gemma2 batched": ("paged_attention hd=256 g=2",
                                    "paged_attention_chunk hd=256 g=2"),
                 "gemma checkpoint int8": ("flash_gqa hd=256 g=1", "paged_attention hd=256 g=1",
                                           "paged_attention_chunk hd=256 g=1"),
                 "phi3 checkpoint int8": ("paged_attention hd=96 g=1",
                                          "paged_attention_chunk hd=96 g=1"),
                 "phi3 checkpoint int4": ("paged_attention hd=96 g=1",
                                          "paged_attention_chunk hd=96 g=1"),
                 "qwen2 checkpoint int8": ("flash_gqa hd=128 g=7", "paged_attention hd=128 g=7",
                                           "paged_attention_chunk hd=128 g=7"),
                 "tp4": ("flash_gqa hd=128 g=4",),
                 "tp4 batched": ("paged_attention hd=128 g=4",
                                 "paged_attention_chunk hd=128 g=4"),
                 "train moe": ("moe_grouped_stack w=f32", "moe_grouped_stack dx w=f32")}


def missing_kernels(label: str, counts: dict, variants: dict) -> list:
    """The kernels and instantiations of run `label`'s path that did not launch."""
    return ([k for k in PATH_KERNELS[label] if counts[k] == 0]
            + [k for k in PATH_VARIANTS.get(label, ()) if not variants.get(k)])


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


def open_system(cfg, encoder=None, cross=None, llm=None, devices=None):
    """RagSystem on the card (``devices``: its mesh's, for the corpus axis).
    The models not given are loaded by RagSystem itself from cfg.model's
    checkpoints, each load timed (``timed_loaders``). Then ingest + embed +
    index, or the saved artifact; a stored vector must then find itself
    first."""
    import torch
    from ragmeup_tpu_torch.pipeline.system import RagSystem
    with timed_loaders():
        system = RagSystem(cfg, encoder=encoder, cross_encoder=cross, llm=llm,
                           device="cuda", eager_load=False, devices=devices)
    t0 = time.perf_counter()
    system.load_data()
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


# ---------------------------------------------------------------------------
# phase 4a: checkpoints written on the card and loaded by RagSystem
# ---------------------------------------------------------------------------

DISK_SPARE = 2e9        # bytes the 8B checkpoint leaves free on the temp disk
RERANK_WAVE = 64        # pairs in one rerank wave: the cross-encoder's batch
CKPT_MIN_LAYERS = 2
LOADERS = ("load_sentence_encoder", "load_cross_encoder", "load_local_llm")
CHECKPOINTS = []        # every write and load: seconds, GB, GB/s, GiB allocated after


def checkpoint_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.endswith(".safetensors")) / 1e9


def write_checkpoint(root: str, model: str, seed: int, layers=None) -> str:
    """One synthetic checkpoint (tools/synthetic_checkpoint.py), drawn on the
    card; logs its seconds and GB/s."""
    from ragmeup_tpu_torch.tools import synthetic_checkpoint
    path = os.path.join(root, model)
    r = synthetic_checkpoint.write_checkpoint(path, model, layers=layers, seed=seed)
    row = {"write": model, "layers": layers, "GB": round(r["bytes"] / 1e9, 3),
           "s": round(r["seconds"], 2), "GBps": round(r["bytes"] / 1e9 / r["seconds"], 3),
           "tokenizer_tokens": int(r["tokenizer_tokens"]),
           "tokenizer_s": round(r["tokenizer_seconds"], 2)}
    CHECKPOINTS.append(row)
    log(f"checkpoint written: {json.dumps(row)}")
    return path


def write_checkpoints(root: str, seed: int) -> dict:
    """The two BERT checkpoints and the Llama-3.1-8B one, at full depth if
    the temp disk holds it with DISK_SPARE to spare, else at as many whole
    layers as fit (at least CKPT_MIN_LAYERS), which is logged."""
    from ragmeup_tpu_torch.tools.synthetic_checkpoint import checkpoint_bytes
    os.makedirs(root, exist_ok=True)
    bert = checkpoint_bytes("gist_small") + checkpoint_bytes("minilm_l6_cross")
    full = 32
    layers = layers_that_fit(root, "llama31_8b", full, beside=bert)
    return {"embedding": write_checkpoint(root, "gist_small", seed),
            "cross_encoder": write_checkpoint(root, "minilm_l6_cross", seed + 1),
            "llm": write_checkpoint(root, "llama31_8b", seed + 2,
                                    layers=None if layers == full else layers)}


def layers_that_fit(root: str, model: str, full: int, beside: float = 0.0) -> int:
    """`full` if the temp disk holds `model` at full depth (and `beside`
    bytes more) with DISK_SPARE to spare, else as many whole layers as fit,
    at least CKPT_MIN_LAYERS; logged."""
    import shutil
    from ragmeup_tpu_torch.tools.synthetic_checkpoint import checkpoint_bytes
    free = shutil.disk_usage(root).free
    rest = checkpoint_bytes(model, 0)
    per_layer = checkpoint_bytes(model, 1) - rest
    layers = max(CKPT_MIN_LAYERS, min(full, int((free - DISK_SPARE - beside - rest)
                                                // per_layer)))
    log(f"temp disk {root}: {free / 1e9:.1f} GB free; {model} at {layers} layers"
        + ("" if layers == full else
           f" (full depth needs {(rest + full * per_layer) / 1e9:.2f} GB and "
           f"{DISK_SPARE / 1e9:.0f} GB spare)"))
    return layers


def with_checkpoints(cfg, ckpts: dict):
    """cfg with all three models set to the checkpoint directories."""
    cfg.model.embedding_checkpoint = ckpts["embedding"]
    cfg.model.cross_encoder_checkpoint = ckpts["cross_encoder"]
    cfg.model.llm_checkpoint = ckpts["llm"]
    return cfg


@contextlib.contextmanager
def timed_loaders():
    """Inside: each loader RagSystem calls with a checkpoint directory is
    timed (host clock around a synchronised call) and logged with the GB it
    read, GB/s and the card's GiB allocated after it."""
    import torch
    from ragmeup_tpu_torch.pipeline import system as system_mod
    real = {name: getattr(system_mod, name) for name in LOADERS}

    def timed(name, fn):
        def load(checkpoint_dir, *args, **kwargs):
            if not checkpoint_dir:
                return fn(checkpoint_dir, *args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(checkpoint_dir, *args, **kwargs)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            gb = checkpoint_gb(checkpoint_dir)
            row = {"load": os.path.basename(checkpoint_dir), "by": name,
                   "quantization": kwargs.get("quantization", "none"),
                   "w4a8": kwargs.get("int4_w4a8", False), "GB": round(gb, 3),
                   "s": round(sec, 2), "GBps": round(gb / sec, 3),
                   "GiB_allocated": round(torch.cuda.memory_allocated() / 2**30, 2)}
            CHECKPOINTS.append(row)
            log(f"checkpoint loaded: {json.dumps(row)}")
            return out
        return load
    for name, fn in real.items():
        setattr(system_mod, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(system_mod, name, fn)


TOKENIZERS = {"models": {}}   # each loaded model's tokenizer, the goldens, host times


def check_tokenizers(models: dict) -> None:
    """Each model loaded from a checkpoint must tokenize through the
    port's tokenizer.json reader (HFTokenizer), not SimpleTokenizer's
    hashes; logs each one's kind and vocabulary."""
    from ragmeup_tpu_torch.models.tokenizer import HFTokenizer
    for label, tok in models.items():
        if not isinstance(tok, HFTokenizer):
            raise AssertionError(f"{label}: tokenizer {type(tok).__name__}, not the "
                                 "tokenizer.json reader")
        TOKENIZERS["models"][label] = {"kind": type(tok).__name__, "vocab": tok.vocab_size}
        log(f"tokenizer of {label}: {json.dumps(TOKENIZERS['models'][label])}")


def check_tokenizer_goldens() -> None:
    """Each structure's golden tokenizer.json, built again on this host and
    read by the reader, must give the goldens' ids (tests hold them against
    the `tokenizers` wheel on the CPU)."""
    from ragmeup_tpu_torch.tools import synthetic_tokenizer
    t0 = time.perf_counter()
    res = synthetic_tokenizer.check_goldens()
    TOKENIZERS["goldens"] = {k: {"ids": v["ids"], "s": round(v["s"], 2)} for k, v in res.items()}
    differ = {k: v["differ"] for k, v in res.items() if v["differ"]}
    log(f"tokenizer goldens ({len(synthetic_tokenizer.GOLDEN_STRINGS)} strings a structure, "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(TOKENIZERS['goldens'])}")
    if differ:
        raise AssertionError(f"tokenizer ids differ from the goldens: {differ}")


@contextlib.contextmanager
def timed_encodes(tok, calls: list):
    """Inside: each ``tok.encode`` appends (characters, ids, ms) to calls."""
    encode = tok.encode

    def timed(text, *args, **kwargs):
        t0 = time.perf_counter()
        ids = encode(text, *args, **kwargs)
        calls.append((len(text), len(ids), (time.perf_counter() - t0) * 1e3))
        return ids
    tok.encode = timed
    try:
        yield
    finally:
        del tok.encode


def tokenizer_host_times(ckpts: dict, texts, query: str, prompt_calls: list) -> dict:
    """Host seconds of the reader on this card's host: the N_DOCS corpus
    through a fresh embedder tokenizer (cold cache, as at ingest), one
    rerank wave (the cross-encoder's batch of pairs) through a fresh one,
    and the 8B's prompts as the default requests encoded them."""
    from ragmeup_tpu_torch.models.tokenizer import load_tokenizer
    out = {}
    for label, key in (("embedder", "embedding"), ("reranker", "cross_encoder"),
                       ("llm", "llm")):
        t0 = time.perf_counter()
        load_tokenizer(ckpts[key])
        out[f"{label}_load_s"] = time.perf_counter() - t0
    emb = load_tokenizer(ckpts["embedding"])
    t0 = time.perf_counter()
    n = sum(len(emb.encode(t)) for t in texts)
    out["corpus"] = {"docs": len(texts), "ids": n, "s": time.perf_counter() - t0}
    cross = load_tokenizer(ckpts["cross_encoder"])
    wave = [(query, t) for t in texts[:RERANK_WAVE]]
    t0 = time.perf_counter()
    n = sum(len(cross.encode_pair(a, b, max_len=512)[0]) for a, b in wave)
    out["rerank_wave"] = {"pairs": len(wave), "ids": n, "s": time.perf_counter() - t0}
    out["llm_prompts"] = [{"chars": c, "ids": i, "ms": ms} for c, i, ms in prompt_calls]
    TOKENIZERS["host_times"] = out
    log(f"tokenizer host times ({card_line()}): {json.dumps(out)}")
    return out


def check_loaded_decoder(llm, ckpt_dir: str, middle: int = 15) -> int:
    """The streaming loader against the generic path on the card: the
    checkpoint's tensors of the first, middle (``middle`` at full depth) and
    last layers, the embedding, the final norm and the head (Phi-3's packed
    tensors split first; biases and norms included), through
    ``llama_params_from_hf`` (f32 on the host) and ``quantize_decoder_params``
    on the card, must be torch.equal to the loaded model's. Returns the
    number of tensors compared."""
    import torch
    from ragmeup_tpu_torch.models import hf_loader
    from ragmeup_tpu_torch.models.safetensors import load_safetensors
    c = llm.cfg
    layers = sorted({0, min(middle, c.num_layers - 1), c.num_layers - 1})
    t0 = time.perf_counter()
    tensors = load_safetensors(ckpt_dir)
    if any(k.endswith("self_attn.qkv_proj.weight") for k in tensors):
        tensors = hf_loader.split_packed_tensors(tensors, c.num_heads, c.num_kv_heads,
                                                 c.head_dim)
    host = hf_loader.llama_params_from_hf(tensors, c.num_layers, c.tie_embeddings,
                                          layers=layers)
    del tensors
    want = hf_loader.quantize_decoder_params(
        {k: v.cuda() for k, v in host.items()}, bits={"int8": 8, "int4": 4}[c.quantization],
        int4_group=c.int4_group, head_bits=8 if c.head_quantization == "int8" else 0)
    del host
    got = llm.model.state_dict()
    missing = sorted(set(want) - set(got))
    differ = [k for k in want if k in got and not torch.equal(got[k], want[k])]
    if missing or differ:
        raise AssertionError(f"loaded {c.quantization} decoder against the generic path: "
                             f"missing {missing[:4]}, differ {differ[:4]} "
                             f"({len(differ)} of {len(want)})")
    n = len(want)
    del want
    free_card()
    log(f"  {c.quantization}{' W4A8' if c.int4_w4a8 else ''} loaded decoder: layers "
        f"{layers}, embedding, final norm and head torch.equal to the generic path "
        f"({n} tensors, {time.perf_counter() - t0:.1f} s)")
    return n


def check_8b_checkpoint(llm, ckpt_dir: str) -> None:
    """A decoder RagSystem loaded from the 8B checkpoint: its EOS ids, the
    streaming loader against the generic path, decode against prefill."""
    if llm.eos_ids != {128001, 128009}:
        raise AssertionError(f"EOS ids {llm.eos_ids} from generation_config.json")
    check_loaded_decoder(llm, ckpt_dir)
    log(f"  decode step vs prefill logits cosine {check_decoder(llm):.5f}; "
        f"max_seq_len {llm.cfg.max_seq_len}, EOS {sorted(llm.eos_ids)}")


def run_moe_checkpoint(root: str, seed: int) -> dict:
    """A Mixtral-8x7B checkpoint at full width and two layers, loaded in int8
    and in int4 by load_local_llm: the expert stacks and every other tensor
    of both layers torch.equal to the generic path; one greedy generate of 8
    tokens (one token a forward) must launch #10 or #13. The directory is
    deleted after."""
    import shutil
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.pipeline import system as system_mod
    path = write_checkpoint(root, "mixtral_8x7b", seed + 3, layers=2)
    runs = {}
    prompt = list(range(100, 160))
    for quantization, label in (("int8", "moe checkpoint int8"),
                                ("int4", "moe checkpoint int4")):
        with timed_loaders():
            llm = system_mod.load_local_llm(path, quantization=quantization,
                                            device="cuda")
        check_tokenizers({f"mixtral_8x7b {quantization}": llm.tokenizer})
        check_loaded_decoder(llm, path)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = llm.generate(prompt, max_new_tokens=8, temperature=0.0, speculative="off")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = kernels.launch_counts()
        log(f"{label}: {len(out)} greedy tokens {out} in {sec * 1e3:.1f} ms; "
            f"launch counts {counts}")
        if not out:
            raise AssertionError(f"{label}: no token generated")
        missing = missing_kernels(label, counts, {})
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
        runs[label] = {"counts": counts, "latency_s": [sec]}
        del llm
        free_card()
    shutil.rmtree(path)
    return runs


# ---------------------------------------------------------------------------
# phases 5c and 5d: the other checkpoint families
# ---------------------------------------------------------------------------


def run_gemma2(seed: int, root: str, data_dir: str, index_dir: str, queries, first_turns,
               encoder, cross) -> dict:
    """Phase 5c: Gemma-2-9B's layout at full width and depth (18.5 GB, or as
    many layers as the temp disk holds), loaded int8 by RagSystem from
    model.llm_checkpoint beside phase 4a's encoders and phase 4's bf16
    index: its config (head_dim 256, softcaps 50/30, scale 1/16, window 4096
    on the even layers, tied head) and EOS id, layers 0, 21 and 41, the
    embedding and the norms torch.equal to the generic path, decode against
    prefill; three default requests ("gemma2": #1 and #3; the softcapped
    prefill takes the einsum, so #8 must not launch), then the batched
    /chat of phase 6 ("gemma2 batched": #9 decode and chunk at hd 256, g 2,
    with the softcap, the scale and the windows); each generation must
    return tokens, whose text may be empty (EMPTY_TEXT_RUNS). The directory
    is deleted after."""
    import shutil
    from ragmeup_tpu_torch.tools.synthetic_checkpoint import GEMMA2_9B
    full = GEMMA2_9B["num_hidden_layers"]
    layers = layers_that_fit(root, "gemma2_9b", full)
    path = write_checkpoint(root, "gemma2_9b", seed + 4,
                            layers=None if layers == full else layers)
    cfg = rag_config(data_dir, index_dir)
    cfg.model.llm_checkpoint = path
    system = open_system(cfg, encoder, cross)
    llm = system.llm
    check_tokenizers({"gemma2_9b": llm.tokenizer})
    c = llm.cfg
    want = {"head_dim": 256, "attn_softcap": 50.0, "final_softcap": 30.0,
            "query_scale": 1 / 16, "post_norms": True, "tie_embeddings": True,
            "quantization": "int8", "layer_windows": tuple(
                4096 if i % 2 == 0 else 0 for i in range(c.num_layers))}
    got = {k: getattr(c, k) for k in want}
    if got != want or llm.eos_ids != {1}:
        raise AssertionError(f"Gemma-2-9B config {got}, EOS {llm.eos_ids}")
    check_loaded_decoder(llm, path, middle=21)
    log(f"  decode step vs prefill logits cosine {check_decoder(llm):.5f}; max_seq_len "
        f"{c.max_seq_len}, EOS {sorted(llm.eos_ids)}")
    ids = GeneratedIds(llm.tokenizer)
    runs = {"gemma2": drive("gemma2", system, llm, queries)}
    runs["gemma2"]["generated"] = ids.check("gemma2", llm.tokenizer.special_ids)
    if runs["gemma2"]["counts"]["flash_gqa"]:
        raise AssertionError("gemma2: the softcapped prefill launched the flash kernel")
    del system
    free_card()
    cfg = rag_config(data_dir, index_dir)
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, llm)
    runs["gemma2 batched"] = drive_batched(batched, first_turns, label="gemma2 batched")
    runs["gemma2 batched"]["generated"] = ids.check("gemma2 batched",
                                                    llm.tokenizer.special_ids)
    ids.tokenizer.decode = ids.decode
    del batched, llm
    free_card()
    shutil.rmtree(path)
    return runs


def engine_request(llm, prompt, max_new: int = 8) -> list:
    """One greedy request through the paged engine (128-token pages):
    chunked prefill through #9's chunk mode, decode through its decode
    mode."""
    from ragmeup_tpu_torch.pipeline.serving import ServingEngine
    eng = ServingEngine(llm, num_pages=64, page_size=128, max_pages_per_seq=32)
    eng.add_request("r", prompt, max_new_tokens=max_new, temperature=0.0,
                    repetition_penalty=1.0)
    return eng.run()["r"]


def check_phi3_window(llm, label: str) -> dict:
    """A 2,500-token prompt past Phi-3's 2,047-token window on both routes:
    the dense prefill (the einsum with the window's lower bound) and the
    engine's chunked prefill (#9 with window 2047, hd 96): last-token logits
    cosine >= 0.99, and nearer each other than the engine's to the dense
    prefill without the window (the window must move the logits).""" 
    import dataclasses
    import torch
    from ragmeup_tpu_torch.models.decoder import LocalLLM
    from ragmeup_tpu_torch.pipeline.serving import ServingEngine
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(4, 32000, (2500,), generator=gen).tolist()
    with torch.inference_mode():
        dense = torch.from_numpy(llm.forward_logits(prompt)).float()
        eng = ServingEngine(llm, num_pages=64, page_size=128, max_pages_per_seq=32)
        paged = eng._prefill_into_pages("w", prompt).float().cpu()
        eng.cache.free("w")
        full = LocalLLM(dataclasses.replace(llm.cfg, sliding_window=0), llm.tokenizer,
                        params=llm.model.state_dict(), device="cuda")
        unwindowed = torch.from_numpy(full.forward_logits(prompt)).float()
        del full
    cos = torch.nn.functional.cosine_similarity(dense, paged, dim=0).item()
    res = {"cosine": cos, "max_abs_diff": (dense - paged).abs().max().item(),
           "unwindowed_max_abs_diff": (unwindowed - paged).abs().max().item()}
    log(f"  {label}: 2,500-token prompt, window 2047: engine vs dense prefill "
        f"{json.dumps(res)}")
    if not (cos >= 0.99 and torch.isfinite(paged).all()
            and res["max_abs_diff"] < res["unwindowed_max_abs_diff"]):
        raise AssertionError(f"{label}: engine and dense prefill logits disagree, or the "
                             f"window does not move them: {res}")
    return res


def run_family_checkpoints(root: str, seed: int) -> dict:
    """Phase 5d: four checkpoints at full width and two layers, each loaded by
    load_local_llm and held torch.equal to the generic path (both layers,
    embedding, norms, head, biases), then driven like phase 5b (Qwen3's int8
    MoE layer traced first: a decode step must launch #10's kernel): Gemma-7B
    (int8): 8 greedy tokens after a 1,024-token prompt (its prefill launches
    #8 at hd 256), one engine request (#9 at hd 256); Phi-3-mini (int8 and
    int4): its packed tensors split, check_phi3_window, one engine request
    (#9 at hd 96); Qwen2.5-7B (int8): its q/k/v biases f32 and equal to the
    checkpoint's, 8 greedy tokens after 1,024 (#8 at g 7), one engine
    request (#9 at g 7); Qwen3-30B-A3B: 8 greedy tokens one a forward in
    int8 (#10, 8 slots) and int4 (#13: gate and up at n = 768). Each
    directory is deleted after its runs."""
    import shutil
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.pipeline import system as system_mod
    gen = torch.Generator().manual_seed(seed + 9)
    long_prompt = torch.randint(4, 30000, (1024,), generator=gen).tolist()
    short_prompt = long_prompt[:300]
    runs = {}
    for offset, (model, family, quantizations) in enumerate((
            ("gemma_7b", "gemma", ("int8",)), ("phi3_mini_4k", "phi3", ("int8", "int4")),
            ("qwen25_7b", "qwen2", ("int8",)), ("qwen3_30b_a3b", "qwen3_moe", ("int8", "int4")))):
        path = write_checkpoint(root, model, seed + 5 + offset, layers=2)
        for quantization in quantizations:
            label = f"{family} checkpoint {quantization}"
            with timed_loaders():
                llm = system_mod.load_local_llm(path, quantization=quantization,
                                                device="cuda")
            check_tokenizers({f"{model} {quantization}": llm.tokenizer})
            check_loaded_decoder(llm, path)
            extra = {}
            if family == "qwen2":
                from ragmeup_tpu_torch.models.safetensors import load_safetensors
                ckpt = load_safetensors(path)
                for i in range(2):
                    for proj in ("q_proj", "k_proj", "v_proj"):
                        bias = getattr(llm.model.layers[i].attention, proj).bias
                        src = ckpt[f"model.layers.{i}.self_attn.{proj}.bias"]
                        if bias.dtype != torch.float32 or not torch.equal(
                                bias.cpu(), src.float()):
                            raise AssertionError(f"{label}: layer {i} {proj} bias differs")
                del ckpt
            if family == "phi3":
                extra["window"] = check_phi3_window(llm, label)
            if family == "qwen3_moe" and quantization == "int8":
                moe_layer_kernels(llm, 1, "rk_moe_gather_stream_kernel")
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prompt = long_prompt if family in ("gemma", "qwen2") else long_prompt[:60]
            out = llm.generate(prompt, max_new_tokens=8, temperature=0.0, speculative="off")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            served = []
            if family != "qwen3_moe":
                served = engine_request(llm, short_prompt)
                torch.cuda.synchronize()
            counts, variants = kernels.launch_counts(), kernels.variant_counts()
            log(f"{label}: {len(out)} greedy tokens {out} in {sec * 1e3:.1f} ms after "
                f"{len(prompt)} prompt tokens; engine {served}; launch counts {counts}; by "
                f"head dim and group {variants}")
            if len(out) != 8 or (family != "qwen3_moe" and len(served) != 8):
                raise AssertionError(f"{label}: {len(out)} tokens, engine {len(served)}")
            missing = missing_kernels(label, counts, variants)
            if missing:
                raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
            runs[label] = {"counts": counts, "variants": variants, "latency_s": [sec], **extra}
            del llm
            free_card()
        shutil.rmtree(path)
    return runs


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
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    log(f"{label}: launch counts over its {len(queries)} requests: {counts}; by head dim "
        f"and group: {variants}")

    for i, out in enumerate(outs):
        check_reply(label, i, out, first_turn=i != 2)
    missing = missing_kernels(label, counts, variants)
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    return {"counts": counts, "variants": variants, "latency_s": latencies,
            "documents": [[d["pk"] for d in out["documents"]] for out in outs]}


# Runs on a random decoder with a tied head and an embedding scaled by
# sqrt(hidden) (Gemma-2-9B's checkpoint): the last input token's embedding
# dominates the head's logits (9.6 against 5.1 for the next token, read on
# an H100), so the decoder repeats the prompt's closing token, whose text
# may be blank or none (with SimpleTokenizer it was special id 3). run_gemma2
# holds instead that each generation returned its tokens (GeneratedIds).
EMPTY_TEXT_RUNS = ("gemma2", "gemma2 batched")


class GeneratedIds:
    """Records the ids each reply is decoded from: wraps ``tokenizer.decode``
    (LocalLLM.generate_text and the batched backend decode through it)."""

    def __init__(self, tokenizer):
        self.calls = []
        self.tokenizer, self.decode = tokenizer, tokenizer.decode
        tokenizer.decode = self

    def __call__(self, ids):
        self.calls.append([int(t) for t in ids])
        return self.decode(ids)

    def check(self, label: str, special_ids) -> dict:
        """Every generation returned tokens; the share of special ids."""
        if not self.calls or not all(self.calls):
            raise AssertionError(f"{label}: a generation returned no token: "
                                 f"{[len(c) for c in self.calls]}")
        toks = [t for c in self.calls for t in c]
        res = {"generations": len(self.calls), "tokens": len(toks),
               "special": sum(t in special_ids for t in toks)}
        log(f"{label}: generated ids {json.dumps(res)}")
        self.calls = []
        return res


def check_reply(label: str, i: int, out: dict, first_turn: bool) -> None:
    """A reply is non-empty (for EMPTY_TEXT_RUNS a string); a fetch brings
    valid documents; a first turn must fetch, and a follow-up that does not
    fetch carries no documents."""
    if not isinstance(out["reply"], str) or not (out["reply"] or label in EMPTY_TEXT_RUNS):
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
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
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
    log(f"{label}: launch counts over its {n + 1} requests: {counts}; by head dim and "
        f"group: {variants}")
    if engine._B_hwm < 1 << (n - 1).bit_length():
        raise AssertionError(f"{label}: the wave batch reached {engine._B_hwm} rows, "
                             f"not {1 << (n - 1).bit_length()}: the first turns did not "
                             f"overlap")
    missing = missing_kernels(label, counts, variants)
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
    return {"counts": counts, "variants": variants, "latency_s": latencies,
            "llm_calls": stats,
            "waves": summary, "prefix_hits": cache.prefix_hits, "rows": engine._B_hwm}


# ---------------------------------------------------------------------------
# phase 6b: greedy decoding, speculative
# ---------------------------------------------------------------------------

SPAN_TOL = 0.02  # blockwise against full-matrix span masses, relative
PEAKED_STD = 2.0  # score standard deviation of peaked_span_mass's scaled queries
SPEC_COS = 0.99  # a verify row against the prefill's at its position (check_decoder's bar)
# |logit difference| of a verify forward from prefill and decode steps: twice
# the largest sound reading of the 8B int8 decoder on an H100 (PERF.md §6)
SPEC_LOGIT_TOL = 1.0


def count_int8_rows():
    """A spy on the name models/decoder.py calls #3 by: records the rows m
    of every call. Returns (rows, restore)."""
    from ragmeup_tpu_torch.models import decoder
    rows = []
    real = decoder.int8_matmul

    def spy(x, *args, **kwargs):
        rows.append(x.shape[0])
        return real(x, *args, **kwargs)
    decoder.int8_matmul = spy
    return rows, lambda: setattr(decoder, "int8_matmul", real)


def spec_stats(llm) -> list:
    """Wrap ``llm.generate_speculative`` so that each call appends its
    verify forwards, accepted drafts and tokens to the returned list."""
    calls = []
    real = llm.generate_speculative

    def wrapped(*args, return_stats=False, **kwargs):
        out, stats = real(*args, return_stats=True, **kwargs)
        calls.append(dict(stats, tokens=len(out)))
        return (out, stats) if return_stats else out
    llm.generate_speculative = wrapped
    return calls


def per_forward(calls) -> str:
    fwd = sum(c["iters"] for c in calls)
    toks = sum(c["tokens"] for c in calls)
    acc = sum(c["accepted"] for c in calls)
    # each call's first token comes from its prefill, the rest from verify forwards
    rate = (toks - len(calls)) / fwd if fwd else 0.0
    return (f"{len(calls)} calls, {toks} tokens, {fwd} verify forwards, {acc} drafts "
            f"accepted, {rate:.3f} tokens a verify forward")


def verify_against(llm, prompt, chunk) -> dict:
    """One verify forward of `chunk` after `prompt` (LocalLLM._verify: #3 at
    m = len(chunk), einsum attention with its in-chunk mask) against two
    references over the same tokens: len(chunk) decode steps (_decode, a
    one-token _verify: #3 at m = 1), and the rows of a causal prefill of
    prompt + chunk (the flash kernel, its own positions and mask code, #3
    replaced by the dequantized matmul). The same chunk also goes through
    two broken verify forwards, one with the in-chunk mask dropped and one
    with its positions off by one, to show that the limits catch them.
    Returns, for each pair, the logits' largest |difference| and least row
    cosine, and the hidden state's relative difference after each layer."""
    import torch
    from ragmeup_tpu_torch.models.decoder import causal_bias
    n, d = len(prompt), len(chunk)
    dev = llm.device
    nl = llm.cfg.num_layers
    hidden = []
    handles = [layer.register_forward_hook(
        lambda mod, args, out: hidden.append(out[0][0].float()))
        for layer in llm.model.layers]

    def taken():
        """The hidden rows the hooks saw since the last call, (layers, rows, h)."""
        h = torch.cat([torch.stack(hidden[i:i + nl]) for i in range(0, len(hidden), nl)],
                      dim=1)
        hidden.clear()
        return h

    try:
        with torch.inference_mode():
            _, caches = llm._prefill(llm._padded(prompt, llm._bucket(n)), n,
                                     llm._bucket(n + 40))
            copies = [[tuple(t.clone() for t in layer) for layer in caches]
                      for _ in range(3)]
            hidden.clear()
            logits = {"verify": llm._verify(chunk, n, caches).float()}
            h = {"verify": taken()}
            logits["steps"] = torch.stack([llm._decode(t, n + i, copies[0])
                                           for i, t in enumerate(chunk)]).float()
            h["steps"] = taken()
            L = llm._bucket(n + d)
            logits["prefill"] = llm.model(
                llm._padded(list(prompt) + list(chunk), L), torch.arange(L, device=dev),
                attn_bias=causal_bias(L, L, device=dev))[0, n:n + d].float()
            h["prefill"] = taken()[:, n:n + d]
            ids = torch.tensor([list(chunk)], device=dev)
            pos = torch.arange(n, n + d, device=dev)
            keys = torch.arange(caches[0][0].shape[1], device=dev)
            logits["no in-chunk mask"] = llm.model(
                ids, pos, attn_bias=torch.where(keys < n + d, 0.0, -1e30)[None, None, None],
                caches=copies[1], cache_pos=n)[0].float()
            logits["positions + 1"] = llm.model(
                ids, pos + 1,
                attn_bias=torch.where(keys[None] <= pos[:, None], 0.0, -1e30)[None, None],
                caches=copies[2], cache_pos=n)[0].float()
            hidden.clear()
    finally:
        for handle in handles:
            handle.remove()

    def pair(a, b):
        x, y = logits[a], logits[b]
        return {"max_abs": (x - y).abs().max().item(),
                "min_cos": torch.nn.functional.cosine_similarity(x, y, dim=-1).min().item()}

    def drift(a, b):
        return ((h[a] - h[b]).norm(dim=(1, 2)) / h[b].norm(dim=(1, 2))).tolist()
    out = {f"{a} vs {b}": pair(a, b) for a, b in (
        ("verify", "steps"), ("verify", "prefill"), ("steps", "prefill"),
        ("no in-chunk mask", "prefill"), ("positions + 1", "prefill"))}
    out["drift verify vs steps"] = drift("verify", "steps")
    out["drift steps vs prefill"] = drift("steps", "prefill")
    out["logit std"] = logits["prefill"].std().item()
    return out


def int8_row_invariance(llm) -> float:
    """#3 at m = 8 against 8 calls at m = 1 on layer 0's q projection (the
    split-K plan reads m, so the partial sums add in another order)."""
    import torch
    from ragmeup_tpu_torch.ops.quant_matmul import int8_matmul
    proj = llm.model.layers[0].attention.q_proj
    dev = proj.kernel_q.device
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(8, proj.kernel_q.shape[0], generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        eight = int8_matmul(x, proj.kernel_q, proj.scale).float()
        ones = torch.cat([int8_matmul(x[i:i + 1], proj.kernel_q, proj.scale)
                          for i in range(8)]).float()
    return (eight - ones).abs().max().item()


def check_spec_stream(llm, seed: int) -> dict:
    """generate(speculative="auto") against ("off") on a 1,000-token prompt,
    32 tokens at repetition penalty 1.1. First the verify forward itself
    (verify_against, at that prompt and at its first 24 tokens): each of
    its rows within cosine SPEC_COS of the prefill's at the same position,
    as check_decoder holds a decode step, and its logits within
    SPEC_LOGIT_TOL of the prefill's and of 8 decode steps'; both broken
    forwards must fail those limits. The streams must then be equal, or
    differ first where the plain path's penalized margin between its token
    and the spec token is at most twice the verify forward's difference
    from the decode steps (the parity contract of ServingEngine._spec_run)."""
    import torch
    from ragmeup_tpu_torch.models.decoder import penalize
    gen = torch.Generator().manual_seed(seed + 3)
    prompt = torch.randint(4, min(30000, llm.cfg.vocab_size), (1000,), generator=gen).tolist()
    rp = 1.1
    times = {}
    streams = {}
    for mode in ("auto", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams[mode] = llm.generate(prompt, 32, temperature=0.0, repetition_penalty=rp,
                                     speculative=mode)
        torch.cuda.synchronize()
        times[mode] = (time.perf_counter() - t0) * 1e3
    spec, plain = streams["auto"], streams["off"]
    n = len(prompt)
    log(f"greedy stream: speculative {times['auto']:.1f} ms, plain {times['off']:.1f} ms "
        f"for 32 tokens after {n}; #3 at m = 8 against 8 calls at m = 1: largest "
        f"|difference| {int8_row_invariance(llm):.5f}")
    out = {"equal": spec == plain, "spec_ms": times["auto"], "plain_ms": times["off"]}
    for label, head in (("1,000", prompt), ("24", prompt[:24])):
        r = verify_against(llm, head, plain[:8])
        nl = llm.cfg.num_layers
        at = sorted({0, 1, 2, 4, 8, 16, nl - 1} & set(range(nl)))
        log(f"verify forward after {label} tokens: " + json.dumps(
            {key: (val if isinstance(val, float) or "drift" not in key
                   else {i: round(val[i], 5) for i in at})
             for key, val in r.items()}))
        sound = all(r[key]["min_cos"] >= SPEC_COS and r[key]["max_abs"] <= SPEC_LOGIT_TOL
                    for key in ("verify vs prefill", "verify vs steps"))
        if not sound:
            raise AssertionError(f"the verify forward after {label} tokens disagrees with "
                                 f"the prefill or the decode steps beyond cosine {SPEC_COS} "
                                 f"or |logit difference| {SPEC_LOGIT_TOL}: {r}")
        for broken in ("no in-chunk mask", "positions + 1"):
            b = r[f"{broken} vs prefill"]
            if b["min_cos"] >= SPEC_COS and b["max_abs"] <= SPEC_LOGIT_TOL:
                raise AssertionError(f"the verify limits pass a forward with {broken} "
                                     f"after {label} tokens: {b}")
        out[label] = r
    diff = out["1,000"]["verify vs steps"]["max_abs"]
    out["diff"] = diff
    if spec == plain:
        log("greedy stream: speculative == plain")
        return out
    i = next(k for k in range(min(len(spec), len(plain))) if spec[k] != plain[k])
    with torch.inference_mode():
        logits, caches = llm._prefill(llm._padded(prompt, llm._bucket(n)), n,
                                      llm._bucket(n + 32))
        for k in range(i):
            logits = llm._decode(plain[k], n + k, caches)
        lg = penalize(logits.float(), llm._seen(prompt + plain[:i]), rp)
        margin = (lg[plain[i]] - lg[spec[i]]).item()
    out.update(position=i, margin=margin)
    log(f"greedy stream: first difference at token {i}: plain {plain[i]}, spec {spec[i]}, "
        f"the plain path's penalized margin {margin:.5f} against 2 x {diff:.5f}")
    if margin > 2 * diff:
        raise AssertionError(f"speculative stream differs from plain at {i} with a "
                             f"margin {margin} above twice the paths' difference {diff}")
    return out


def check_forced_acceptance(llm, seed: int, stats: list) -> dict:
    """The final norm's weight zeroed: every logit is 0, the argmax token 0,
    and after a prompt ending in 16 zeros every 2-gram draft is accepted.
    32 tokens take at most 5 verify forwards; one engine request with the
    same prompt is done in its first spec wave of 8 iterations, where plain
    8-step waves take 4. The weight is restored after."""
    import torch
    from ragmeup_tpu_torch.pipeline.serving import ServingEngine
    if 0 in llm.eos_ids:
        raise AssertionError("token 0 is an EOS id")
    gen = torch.Generator().manual_seed(seed + 4)
    prompt = torch.randint(4, min(30000, llm.cfg.vocab_size), (100,),
                           generator=gen).tolist() + [0] * 16
    norm = llm.model.final_norm.scale
    saved = norm.detach().clone()
    try:
        with torch.no_grad():
            norm.zero_()
        first = len(stats)
        solo = llm.generate(prompt, 32, temperature=0.0, repetition_penalty=1.1)
        iters = stats[first]["iters"]
        eng = ServingEngine(llm, num_pages=8, page_size=128, max_pages_per_seq=4)
        eng.add_request("spec", prompt, 32, temperature=0.0, repetition_penalty=1.1)
        left = eng.spec_wave_once(iters=8, draft=8)
        spec_out = eng.results()["spec"]
        eng.retire("spec")
        eng.add_request("plain", prompt, 32, temperature=0.0, repetition_penalty=1.1)
        waves = 1
        while eng.wave_once(steps=8) > 0:
            waves += 1
        plain_out = eng.retire("plain")
    finally:
        with torch.no_grad():
            norm.copy_(saved)
    log(f"forced acceptance: solo 32 tokens in {iters} verify forwards "
        f"({stats[first]['accepted']} drafts accepted); engine: one spec wave of 8 "
        f"iterations left {left} rows active with {len(spec_out)} tokens, plain 8-step "
        f"waves {waves}")
    if solo != [0] * 32 or iters > 5:
        raise AssertionError(f"forced acceptance: {iters} verify forwards, {solo}")
    if left != 0 or spec_out != [0] * 32 or plain_out != [0] * 32 or waves != 4:
        raise AssertionError(f"forced acceptance in the engine: {left} active after one "
                             f"spec wave, {spec_out}; plain {waves} waves, {plain_out}")
    return {"solo_iters": iters, "plain_waves": waves}


def check_fused_eos(llm, seed: int) -> dict:
    """The fused generate loop against the host loop on a reply that ends
    in EOS: sampled at temperature 0.2 from one seed, with the host loop's
    ninth token made an EOS id. Both must give the tokens before it. Prints
    the decode forwards each ran and its time: the host loop runs none
    after EOS, the fused loop those it queued before the device's done flag
    reached the host (each masked)."""
    import torch
    gen = torch.Generator().manual_seed(seed + 6)
    prompt = torch.randint(4, min(30000, llm.cfg.vocab_size), (500,), generator=gen).tolist()
    kw = dict(temperature=0.2, repetition_penalty=1.1, seed=seed)
    free = llm.generate(prompt, 32, fused=False, **kw)
    eos = free[8]
    want = free[:free.index(eos)]
    forwards = [0]
    real = llm._decode

    def counted(*args, **kwargs):
        forwards[0] += 1
        return real(*args, **kwargs)
    old = llm.eos_ids
    llm.eos_ids, llm._decode = set(old) | {eos}, counted
    runs = {}
    try:
        for fused in (False, True):
            forwards[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = llm.generate(prompt, 32, fused=fused, **kw)
            torch.cuda.synchronize()
            runs["fused" if fused else "host"] = {
                "tokens": len(toks), "forwards": forwards[0],
                "ms": (time.perf_counter() - t0) * 1e3, "equal": toks == want}
    finally:
        llm.eos_ids = old
        del llm._decode
    log(f"fused loop on a reply ending in EOS after {len(want)} tokens: {json.dumps(runs)}; "
        f"forwards after EOS: fused {runs['fused']['forwards'] - len(want)}, host "
        f"{runs['host']['forwards'] - len(want)}")
    if not (runs["fused"]["equal"] and runs["host"]["equal"]):
        raise AssertionError(f"the generate loops disagree on a reply ending in EOS: {runs}")
    return runs


def peaked_span_mass(q, k, a0: int = 480, a1: int = 512, n_spans: int = 16) -> dict:
    """span_attention_mass where attention is far from uniform (random
    weights leave the model's span masses near uniform, where a wrong scale
    moves them little). Each head's queries a0..a1 are scaled so that their
    visible scores have standard deviation PEAKED_STD. The masses of
    n_spans spans before the queries, averaged over heads, against the full
    softmax matrix computed here in f32, within SPAN_TOL relative; and two
    broken calls must differ from it by more: sm_scale dropped (1 for
    1/sqrt(hd)) and the causal mask dropped (q_offset past every key; the
    queries sit mid-thread, so half the keys are future ones)."""
    import numpy as np
    import torch
    from ragmeup_tpu_torch.ops.attention import span_attention_mass
    L, nh, hd = k.shape
    edges = np.linspace(0, a0 - 2, n_spans + 1).astype(int)
    spans = list(zip(edges[:-1].tolist(), edges[1:].tolist()))
    keys = torch.arange(L, device=k.device)
    q_pos = torch.arange(a0, a1, device=k.device)
    visible = keys[None, :] <= q_pos[:, None]
    runs = {"blockwise": 0.0, "full matrix": 0.0, "sm_scale dropped": 0.0,
            "causal mask dropped": 0.0}
    top = 0.0
    for h in range(nh):
        qh, kh = q[a0:a1, h].float(), k[:, h].float()
        scores = (qh @ kh.T) / math.sqrt(hd)
        qh = qh * (PEAKED_STD / scores[visible].std())
        w = torch.softmax(torch.where(visible, (qh @ kh.T) / math.sqrt(hd), -torch.inf), -1)
        top += w.max(dim=1).values.mean().item() / nh
        runs["full matrix"] += np.array([(w[:, lo:hi].sum(1) / (hi - lo)).mean().item()
                                         for lo, hi in spans]) / nh
        runs["blockwise"] += span_attention_mass(qh, kh, spans, q_offset=a0) / nh
        runs["sm_scale dropped"] += span_attention_mass(qh, kh, spans, q_offset=a0,
                                                        sm_scale=1.0) / nh
        runs["causal mask dropped"] += span_attention_mass(qh, kh, spans, q_offset=L) / nh
    ref = runs["full matrix"]
    err = {key: float(np.abs(val / ref - 1).max()) for key, val in runs.items()
           if key != "full matrix"}
    log(f"blockwise provenance, peaked: queries {a0}..{a1} scaled to score std "
        f"{PEAKED_STD}, mean largest weight of a row {top:.4f} (uniform over its "
        f"keys: {1 / a0:.4f}); span masses {ref.tolist()}; largest relative difference "
        f"from the full matrix {json.dumps(err)} (tolerance {SPAN_TOL})")
    if err["blockwise"] > SPAN_TOL:
        raise AssertionError(f"peaked span masses differ from the full matrix by "
                             f"{err['blockwise']}")
    for broken in ("sm_scale dropped", "causal mask dropped"):
        if err[broken] <= SPAN_TOL:
            raise AssertionError(f"SPAN_TOL passes span masses with the {broken}: "
                                 f"{err[broken]}")
    return {"max_rel_diff": err["blockwise"], "broken": err, "mean_top_weight": top}


def check_blockwise_provenance(llm, seed: int) -> dict:
    """Span masses of a 1,024-token thread's last 32 tokens over four
    spans: blockwise (span_attention_mass per head over qk_forward's q and
    k, whose forward takes the flash kernel at this length, averaged over
    heads) against the last layer of attention_forward (einsum, the heads'
    mean weights); each span's mass within SPAN_TOL of the full matrix's,
    relative: bf16 rounding of the two forwards, 32 layers deep. With
    random weights that attention is near uniform, so peaked_span_mass
    then holds the same q and k where it is not."""
    import numpy as np
    import torch
    from ragmeup_tpu_torch.ops.attention import span_attention_mass
    gen = torch.Generator().manual_seed(seed + 5)
    ids = torch.randint(4, min(30000, llm.cfg.vocab_size), (1024,), generator=gen).tolist()
    spans = [(0, 300), (300, 600), (600, 900), (900, 990)]
    a0, a1 = 992, 1024
    t0 = time.perf_counter()
    q, k = (torch.from_numpy(t[0]).cuda() for t in llm.qk_forward(ids))
    block = sum(span_attention_mass(q[a0:a1, h], k[:, h], spans, q_offset=a0)
                for h in range(q.shape[1]))
    t1 = time.perf_counter()
    att = llm.attention_forward(ids)[-1][0].mean(axis=0)
    t2 = time.perf_counter()
    full = np.array([att[a0:a1, lo:hi].mean() for lo, hi in spans])
    block = block / q.shape[1]
    err = float(np.abs(block / full - 1).max())
    log(f"blockwise provenance: span masses {block.tolist()} against the full "
        f"matrix's {full.tolist()}, largest relative difference {err:.2e} "
        f"(tolerance {SPAN_TOL}); normalized {np.round(block / block.sum(), 5).tolist()}; "
        f"blockwise {(t1 - t0) * 1e3:.1f} ms, full {(t2 - t1) * 1e3:.1f} ms")
    if err > SPAN_TOL:
        raise AssertionError(f"blockwise provenance differs from the full matrix by {err}")
    return {"max_rel_diff": err, "peaked": peaked_span_mass(q, k)}


def watch_gate(engine) -> dict:
    """Instrument the engine's adaptive gate: its mode changes, and the spec
    waves dispatched (and the chunk-attention launches they made) since the
    gate last reset; a demotion needs two spec waves first."""
    from ragmeup_tpu_torch import kernels
    seen = {"changes": [], "spec_waves": 0, "since_reset": 0, "chunk": 0}
    gate, dispatch, reset = engine._spec_gate, engine._spec_dispatch, engine._spec_track_reset

    def watched_gate():
        before = engine._spec_mode
        out = gate()
        if engine._spec_mode != before:
            seen["changes"].append({"to": engine._spec_mode,
                                    "spec_waves_since_reset": seen["since_reset"],
                                    "accept": engine._spec_accept})
            if engine._spec_mode == "plain" and seen["since_reset"] < 2:
                raise AssertionError(f"the gate demoted after {seen['since_reset']} "
                                     f"spec waves")
        return out

    def watched_dispatch(*args, **kwargs):
        before = kernels.launch_counts()["paged_attention_chunk"]
        entry = dispatch(*args, **kwargs)
        if isinstance(entry, dict):
            seen["spec_waves"] += 1
            seen["since_reset"] += 1
            seen["chunk"] += kernels.launch_counts()["paged_attention_chunk"] - before
        return entry

    def watched_reset():
        seen["since_reset"] = 0
        reset()
    engine._spec_gate = watched_gate
    engine._spec_dispatch = watched_dispatch
    engine._spec_track_reset = watched_reset
    return seen


def run_greedy(seed: int, llm, encoder, cross, data_dir: str, index_dir: str,
               queries, first_turns) -> dict:
    """Phase 6b on phase 4's int8 decoder and bf16 index (see the module
    docstring). Returns the runs "greedy" and "greedy batched"."""
    import torch
    from ragmeup_tpu_torch.pipeline import provenance
    t_phase = time.perf_counter()
    runs = {}
    stats = spec_stats(llm)
    cfg = rag_config(data_dir, index_dir)
    cfg.generation.temperature = 0.0
    system = open_system(cfg, encoder, cross, llm)
    rows, restore = count_int8_rows()
    try:
        runs["greedy"] = drive("greedy", system, llm, queries)
    finally:
        restore()
    m8 = sum(1 for m in rows if m == 8)
    log(f"greedy: {per_forward(stats)}; #3 calls by rows m: "
        f"{dict(sorted(collections.Counter(rows).items()))}")
    if not stats or m8 == 0:
        raise AssertionError(f"greedy: no verify forward launched #3 at m = 8 "
                             f"({len(stats)} speculative calls)")
    runs["greedy"]["int8_matmul_m8"] = m8
    runs["greedy"]["spec"] = per_forward(stats)

    check_spec_stream(llm, seed)
    check_forced_acceptance(llm, seed, stats)
    check_fused_eos(llm, seed)

    cfg = rag_config(data_dir, index_dir)
    cfg.generation.temperature = 0.0
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, llm)
    gate = watch_gate(batched.backend.engine)
    runs["greedy batched"] = drive_batched(batched, first_turns, label="greedy batched")
    log(f"greedy batched: {gate['spec_waves']} spec waves launched #9 chunk "
        f"{gate['chunk']} times; gate mode changes {gate['changes']}; acceptance EWMA "
        f"{batched.backend.engine._spec_accept}")
    if gate["spec_waves"] == 0 or gate["chunk"] == 0:
        raise AssertionError("greedy batched: no spec wave launched #9's chunk mode")
    runs["greedy batched"]["gate"] = gate
    del batched

    check_blockwise_provenance(llm, seed)
    cfg = rag_config(data_dir, index_dir)
    cfg.generation.temperature = 0.0
    cfg.pipeline.provenance_method = "attention"
    system = open_system(cfg, encoder, cross, llm)
    real = provenance.compute_attention_provenance
    qk_calls = []
    qk_forward = llm.qk_forward
    llm.qk_forward = lambda ids: qk_calls.append(len(ids)) or qk_forward(ids)
    provenance.compute_attention_provenance = \
        lambda *args, **kwargs: real(*args, blockwise_threshold=64, **kwargs)
    try:
        t0 = time.perf_counter()
        out = system.chat(queries[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        provenance.compute_attention_provenance = real
        del llm.qk_forward
    scores = [d.get("provenance") for d in out["documents"]]
    log(f"attention provenance /chat: {ms:.1f} ms, threads {qk_calls} tokens through "
        f"the blockwise branch, scores {scores}")
    if (not qk_calls or not scores or not all(isinstance(x, float) for x in scores)
            or abs(sum(scores) - 1.0) > 1e-5):
        raise AssertionError(f"attention provenance: scores {scores}, blockwise "
                             f"threads {qk_calls}")
    del llm.generate_speculative
    log(f"greedy phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 4h: the HTTP layer
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
CHAT_KEYS = ("reply", "history", "documents", "rewritten", "question",
             "fetched_new_documents")
SERVER_UP_S = 240       # the entry point's server must answer /health by then
GRAPH_ROWS = (("ada", "engineer", "london"), ("grace", "admiral", "new york"),
              ("alan", "mathematician", "wilmslow"), ("edsger", "professor", "austin"),
              ("barbara", "professor", "boston"), ("ken", "engineer", "murray hill"))


def http(base: str, method: str, path: str, body=None, upload=None,
         timeout: float = 600) -> tuple:
    """One request through urllib: a JSON ``body`` or a multipart ``upload``
    (filename, bytes). Returns (status, content type, body bytes, ms)."""
    import urllib.error
    import urllib.request
    headers, data = {}, None
    if upload is not None:
        boundary = "chip-smoke-" + os.urandom(8).hex()
        name, payload = upload
        data = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                f'filename="{name}"\r\nContent-Type: text/csv\r\n\r\n').encode() \
            + payload + f"\r\n--{boundary}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(base + path, data=data, headers=headers, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, ctype, raw = r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers.get("Content-Type"), e.read()
    return status, ctype, raw, (time.perf_counter() - t0) * 1e3


def http_json(base: str, method: str, path: str, body=None, upload=None,
              status: int = 200) -> tuple:
    """``http`` that must answer ``status`` with JSON → (decoded body, ms)."""
    got, ctype, raw, ms = http(base, method, path, body, upload)
    if got != status or ctype != "application/json":
        raise AssertionError(f"{method} {path}: {got} {ctype} {raw[:300]!r}; "
                             f"want {status} with JSON")
    return json.loads(raw), ms


@contextlib.contextmanager
def serving(app):
    """``app`` on wsgi.serve (127.0.0.1, a free port) in a thread; yields
    its base URL and shuts it down after."""
    from ragmeup_tpu_torch.server import wsgi
    server = wsgi.serve(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def http_copies(tmp: str, data_dir: str, index_dir: str, name: str) -> tuple:
    """Copies of phase 4's data and index directories, so that uploads and
    deletes leave what later phases read as it was."""
    import shutil
    root = os.path.join(tmp, name)
    copies = (os.path.join(root, "data"), os.path.join(root, "index"))
    shutil.copytree(data_dir, copies[0])
    shutil.copytree(index_dir, copies[1])
    return copies


def check_http_reply(label: str, i: int, out: dict, first_turn: bool, sent_docs=None):
    """A /chat body: the contract's keys and a non-empty reply; a fetch
    brings documents (source, content, finite provenance), a first turn
    must fetch, and a follow-up that fetches nothing returns the client's
    documents."""
    missing = [k for k in CHAT_KEYS if k not in out]
    if missing:
        raise AssertionError(f"{label} request {i + 1}: keys {missing} missing")
    if not isinstance(out["reply"], str) or not out["reply"]:
        raise AssertionError(f"{label} request {i + 1}: empty reply")
    docs = out["documents"]
    if out["fetched_new_documents"]:
        if not docs or not all(d.get("s") and isinstance(d.get("c"), str)
                               and math.isfinite(d.get("provenance", 0.0)) for d in docs):
            raise AssertionError(f"{label} request {i + 1}: bad documents {docs[:2]}")
    elif first_turn:
        raise AssertionError(f"{label} request {i + 1}: a first turn must fetch")
    elif docs != (sent_docs or []):
        raise AssertionError(f"{label} request {i + 1}: the client's documents did not "
                             f"round-trip")


def http_default(base: str, system, queries, in_process_s) -> dict:
    """Part 1 of phase 4h on the default server (see the module docstring)."""
    import torch
    from ragmeup_tpu_torch import kernels
    label = "http"
    health, _ = http_json(base, "GET", "/health")
    if health["chunks"] != len(system.store) or health["status"] != "ok":
        raise AssertionError(f"{label}: /health {health} for {len(system.store)} chunks")
    names, _ = http_json(base, "GET", "/get_documents")
    if names != sorted(f for f in os.listdir(system.cfg.data.data_directory)
                       if f.endswith(".csv")):
        raise AssertionError(f"{label}: /get_documents {names}")
    kernels.reset_counts()
    outs, ms = [], []
    bodies = [{"prompt": queries[0]}, {"prompt": queries[1]}]
    for i in range(3):
        if i == 2:
            bodies.append({"prompt": queries[2], "history": outs[1]["history"],
                           "docs": outs[1]["documents"]})
        out, t = http_json(base, "POST", "/chat", bodies[i])
        torch.cuda.synchronize()
        outs.append(out)
        ms.append(t)
        log(f"{label} request {i + 1}: HTTP {t:.1f} ms (phase 4 in process "
            f"{in_process_s[i] * 1e3:.1f} ms), fetched={out['fetched_new_documents']} "
            f"rewritten={out['rewritten']} docs={len(out['documents'])} "
            f"reply={out['reply'][:60]!r}")
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    log(f"{label}: launch counts over its 3 requests: {counts}")
    for i, out in enumerate(outs):
        check_http_reply(label, i, out, first_turn=i != 2,
                         sent_docs=bodies[i].get("docs"))
    missing = missing_kernels(label, counts, variants)
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")

    rows = [[f"upload {i}", f"zulu yankee note {i} about {w} rivers"]
            for i, w in enumerate(("granite", "basalt", "marble", "slate"))]
    text = "title,text\n" + "".join(f"{a},{b}\n" for a, b in rows)
    added, t_add = http_json(base, "POST", "/add_document",
                             upload=("uploaded rows.csv", text.encode()))
    grown, _ = http_json(base, "GET", "/health")
    if added["filename"] != "uploaded_rows.csv" or added["chunks"] <= 0 \
            or grown["chunks"] != health["chunks"] + added["chunks"]:
        raise AssertionError(f"{label}: /add_document {added}, /health {grown}")
    search, t_search = http_json(base, "POST", "/search", {
        "query": "Which notes mention granite rivers?", "session_id": "chip-smoke"})
    check_http_reply(label, 3, search, first_turn=True)
    http_json(base, "POST", "/feedback", {"chat_id": "chip-smoke", "message_offset": 2,
                                          "feedback": 1})
    feedback, _ = http_json(base, "GET", "/feedback?chat_id=chip-smoke")
    if feedback != [{"chat_id": "chip-smoke", "message_offset": 2, "feedback": 1}]:
        raise AssertionError(f"{label}: /feedback returned {feedback}")
    status, ctype, raw, _ = http(base, "POST", "/get_document",
                                 {"filename": "uploaded_rows.csv"})
    if status != 200 or raw != text.encode():
        raise AssertionError(f"{label}: /get_document {status} {ctype}: {raw[:100]!r}")
    deleted, t_del = http_json(base, "POST", "/delete", {"filename": "uploaded_rows.csv"})
    if deleted["count"] != added["chunks"]:
        raise AssertionError(f"{label}: /delete {deleted} after {added}")
    evaluated, t_eval = http_json(base, "POST", "/deepeval_evaluate",
                                  {"sample_size": 3, "qa_pairs": 1})
    pairs = evaluated["evaluation_results"]["pairs"]
    scores = pairs[0]["scores"] if len(pairs) == 1 else {}
    if not scores or not all(0.0 <= v <= 1.0 for v in scores.values()):
        raise AssertionError(f"{label}: /deepeval_evaluate {evaluated}")
    stats, _ = http_json(base, "GET", "/stats")
    if stats["chat_requests"] != 3 or "chat_latency_ms_avg" not in stats:
        raise AssertionError(f"{label}: /stats {stats}")
    status, ctype, page, _ = http(base, "GET", "/")
    if status != 200 or ctype != "text/html; charset=utf-8" or b"chathistory" not in page:
        raise AssertionError(f"{label}: GET / gave {status} {ctype}")
    http_json(base, "GET", "/no_such_route", status=404)
    log(f"{label}: /add_document {t_add:.1f} ms ({added['chunks']} chunks), /search "
        f"{t_search:.1f} ms, /delete {t_del:.1f} ms, /deepeval_evaluate {t_eval:.1f} ms "
        f"scores {json.dumps({k: round(v, 4) for k, v in scores.items()})}; /stats "
        f"chat_latency_ms_avg {stats['chat_latency_ms_avg']:.1f}")
    return {"counts": counts, "variants": variants, "latency_s": [t / 1e3 for t in ms],
            "routes_ms": {"add_document": t_add, "search": t_search, "delete": t_del,
                          "deepeval_evaluate": t_eval}}


def http_batched(base: str, backend, first_turns) -> dict:
    """Part 2: the first turns at once from one thread each, then a
    follow-up, through the paged engine; /stats carries its percentiles
    and prefix-cache counters."""
    import torch
    from ragmeup_tpu_torch import kernels
    label = "http batched"
    n = len(first_turns)
    outs, ms, errors = [None] * n, [0.0] * n, []

    def one(i):
        try:
            outs[i], ms[i] = http_json(base, "POST", "/chat", {"prompt": first_turns[i]})
        except Exception as exc:  # re-raised below, in the main thread
            errors.append(exc)
    kernels.reset_counts()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    follow, t = http_json(base, "POST", "/chat", {
        "prompt": "Tell me more about that.", "history": outs[0]["history"],
        "docs": outs[0]["documents"]})
    torch.cuda.synchronize()
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    for i, out in enumerate(outs + [follow]):
        check_http_reply(label, i, out, first_turn=i < n,
                         sent_docs=outs[0]["documents"] if i == n else None)
    stats, _ = http_json(base, "GET", "/stats")
    gen, cache = stats.get("generation", {}), stats.get("prefix_cache", {})
    log(f"{label}: {n} first turns at once, HTTP ms {[round(x, 1) for x in ms]}, "
        f"follow-up {t:.1f} ms; /stats generation {json.dumps(gen)} prefix_cache "
        f"{json.dumps(cache)}; launch counts {counts}")
    if gen.get("completed", 0) < n + 1 or "ttft_ms_p95" not in gen \
            or "tok_s_p50" not in gen or cache.get("lookups", 0) <= 0:
        raise AssertionError(f"{label}: /stats {stats}")
    missing = missing_kernels(label, counts, variants)
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    backend.stop()
    return {"counts": counts, "variants": variants,
            "latency_s": [x / 1e3 for x in ms + [t]], "stats": stats}


def http_graph(tmp: str, data_dir: str, index_dir: str, models, query: str) -> dict:
    """Part 3: GraphRAG on the native store (a CSV upload becomes Row nodes;
    one /chat makes exactly one decoder call more than the same request
    without the graph: its Cypher), then the sidecar in a subprocess and
    the port's RemoteGraphClient."""
    from ragmeup_tpu_torch.graph.client import RemoteGraphClient
    from ragmeup_tpu_torch.server.app import RagServer
    encoder, cross, llm = models
    systems = {}
    for graph in (True, False):
        cfg = rag_config(*http_copies(tmp, data_dir, index_dir, f"http_graph_{graph}"))
        cfg.graph.enabled = graph
        cfg.pipeline.use_rewrite_loop = False  # one retrieval: one Cypher call
        systems[graph] = open_system(cfg, encoder, cross, llm)
    table = "name,role,city\n" + "".join(",".join(r) + "\n" for r in GRAPH_ROWS)
    calls = time_llm_calls(llm)
    decoder_calls, graph_calls = {}, []
    with serving(RagServer(systems[True])) as base:
        added, _ = http_json(base, "POST", "/add_document",
                             upload=("people.csv", table.encode()))
        nodes = systems[True].graph.run("MATCH (r:Row) RETURN count(r) AS n")[0]["n"]
        if nodes != len(GRAPH_ROWS) or added["chunks"] <= 0:
            raise AssertionError(f"graph: {nodes} Row nodes after {added}")
        for graph, system in systems.items():
            before = len(calls)
            if graph:
                out, ms = http_json(base, "POST", "/chat", {"prompt": query})
                graph_calls, graph_out = calls[before:], out
            else:
                out = system.chat(query)
            decoder_calls[graph] = len(calls) - before
            check_http_reply("graph", int(not graph), {k: out[k] for k in CHAT_KEYS},
                             first_turn=True)
    if decoder_calls[True] != decoder_calls[False] + 1:
        raise AssertionError(f"graph: decoder calls with / without the graph "
                             f"{decoder_calls}")
    cypher = graph_calls[0]  # the graph retriever asks before the answer
    log(f"graph: {len(GRAPH_ROWS)} Row nodes from /add_document ({added['chunks']} "
        f"chunks); /chat {ms:.1f} ms with {decoder_calls[True]} decoder calls against "
        f"{decoder_calls[False]} without the graph (the Cypher call: prompt {cypher[0]} "
        f"tokens, {cypher[1]} new, {cypher[2]:.1f} ms); graph chunks in the reply: "
        f"{sum(d['s'] == 'graph_db' for d in graph_out['documents'])}")
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ragmeup_tpu_torch.graph.sidecar", "--host", "127.0.0.1",
         "--port", str(port), "--db", os.path.join(tmp, "sidecar_graph.json")],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    try:
        client = RemoteGraphClient(f"http://127.0.0.1:{port}", timeout=10)
        while True:
            try:
                client.schema()
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 60:
                    raise AssertionError(f"graph sidecar did not come up: "
                                         f"{proc.stderr.read() if proc.poll() is not None else ''}")
                time.sleep(0.2)
        up = time.perf_counter() - t0
        n = client.add_instances([{"query": "MERGE (t:Topic {name: $n})",
                                   "parameters": {"n": "rivers"}}])
        rows = client.run("MATCH (t:Topic) RETURN t.name")
        client.close()
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    log(f"graph sidecar: up in {up:.1f} s; add_instances {n}, run {rows}; exit code {rc}")
    if n != 1 or rows != [{"t.name": "rivers"}]:
        raise AssertionError(f"graph sidecar round trip: {n}, {rows}")
    return {"decoder_calls": decoder_calls, "rows": nodes, "chat_ms": ms}


def free_port() -> int:
    """A port that was free a moment ago (for a server in a subprocess)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_entry_point(tmp: str, data_dir: str, index_dir: str, ckpt_llm: str,
                     query: str) -> dict:
    """Part 4: ``python -m ragmeup_tpu_torch.server`` in a subprocess, its
    config from an env file (the 8B checkpoint through llm_model, a third
    copy of the directories); /health within SERVER_UP_S, one /chat."""
    import torch
    d, i = http_copies(tmp, data_dir, index_dir, "http_main")
    env_file = os.path.join(tmp, "http_main", "server.env")
    with open(env_file, "w") as f:
        f.write(f"llm_model={ckpt_llm}\ndata_directory={d}\nvector_store_uri={i}\n"
                f"max_new_tokens={MAX_NEW_TOKENS}\n")
    free, total = torch.cuda.mem_get_info()
    log(f"entry point: card memory before the start {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    out_path = os.path.join(tmp, "http_main", "server.log")
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ragmeup_tpu_torch.server", "--env-file", env_file,
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    rc, up, reply = None, None, None
    try:
        while up is None:
            if proc.poll() is not None or time.perf_counter() - t0 > SERVER_UP_S:
                break
            try:
                if http(base, "GET", "/health", timeout=5)[0] == 200:
                    up = time.perf_counter() - t0
            except OSError:
                time.sleep(0.5)
        if up is not None:
            reply = http(base, "POST", "/chat", {"prompt": query})
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    with open(out_path) as f:
        server_log = f.read().strip().splitlines()
    log("entry point: server log: " + " | ".join(server_log[-12:]))
    if up is None:
        raise AssertionError(f"python -m ragmeup_tpu_torch.server did not answer /health "
                             f"within {SERVER_UP_S} s (exit code {rc})")
    status, ctype, raw, ms = reply
    body = json.loads(raw) if ctype == "application/json" else {}
    log(f"entry point: up in {up:.1f} s; /chat {status} in {ms:.1f} ms, reply "
        f"{body.get('reply', '')[:60]!r}; exit code {rc} after SIGTERM")
    if status != 200 or not body.get("reply"):
        raise AssertionError(f"entry point /chat: {status} {raw[:300]!r}")
    return {"up_s": up, "chat_ms": ms, "exit_code": rc}


def run_http(tmp: str, data_dir: str, index_dir: str, models, ckpt_llm: str, queries,
             first_turns, in_process_s) -> dict:
    """Phase 4h (see the module docstring). Returns the runs "http" and
    "http batched"."""
    import importlib.util
    from ragmeup_tpu_torch.server.app import RagServer
    t_phase = time.perf_counter()
    encoder, cross, llm = models
    runs = {}
    system = open_system(rag_config(*http_copies(tmp, data_dir, index_dir, "http")),
                         encoder, cross, llm)
    with serving(RagServer(system)) as base:
        runs["http"] = http_default(base, system, queries, in_process_s)
    del system
    cfg = rag_config(*http_copies(tmp, data_dir, index_dir, "http_batched"))
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, llm)
    with serving(RagServer(batched)) as base:
        runs["http batched"] = http_batched(base, batched.backend, first_turns)
    del batched
    free_card()
    graph = http_graph(tmp, data_dir, index_dir, models, queries[0])
    del llm.generate  # time_llm_calls' wrappers
    entry = http_entry_point(tmp, data_dir, index_dir, ckpt_llm, queries[0])
    runs["http"].update(graph=graph, entry_point=entry)
    log("record only (the port uses neither): werkzeug importable "
        f"{importlib.util.find_spec('werkzeug') is not None}, requests importable "
        f"{importlib.util.find_spec('requests') is not None}")
    log(f"http phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 4i: retrieval at scale
# ---------------------------------------------------------------------------

SHARDS = 4              # corpus shards, all on cuda:0
IVF_N = 1 << 20         # IVF corpus rows (S2's columns)
IVF_BLOBS = 1024        # Gaussian blobs the IVF corpus is drawn from
IVF_SPREAD = 0.03       # a blob's per-coordinate std before normalizing
IVF_EXACT_N = 65536     # rows of the full-probe exactness check
IVF_K = 20
STREAM_BATCHES, STREAM_B = 16, 32


def card_mesh():
    from ragmeup_tpu_torch.parallel.mesh import make_mesh
    return make_mesh((1, SHARDS, 1), devices=["cuda:0"] * SHARDS)


def unit_rows(x):
    return x / x.norm(dim=1, keepdim=True)


def check_sharded_topk(gen) -> dict:
    """Phase 4i (a): sharded_topk at S2 over SHARDS shards on cuda:0, bf16
    and int8, b 1 (row 50, whose duplicates straddle a tile end and the
    boundary of shards 1 and 2) and 32."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import topk
    from ragmeup_tpu_torch.parallel import sharded_index as si
    mesh = card_mesh()
    devs = mesh.axis_devices("corpus")
    _, n, k = TOPK_SHAPES["S2"]
    out = {}
    for kind in ("bf16", "int8"):
        q50, mask, corpus, c_scale = topk_index(gen, kind, n)
        shards = si.split_columns(devs, corpus, 0)
        masks = si.split_columns(devs, mask, topk.NEG_INF)
        scales = None if c_scale is None else si.split_columns(devs, c_scale, 1.0)
        kernel, plain = topk_calls(kind, corpus, c_scale)
        counter = "topk" if kind == "bf16" else "topk_int8"
        extra = unit_rows(torch.randn(31, TOPK_D, generator=gen, device="cuda"))
        for b in (1, 32):
            q = torch.cat([q50[None], extra[:b - 1]])

            def sharded():
                return si.sharded_topk(mesh, q, shards, k, mask=masks, scales=scales)
            kernels.reset_counts()
            got = sharded()
            torch.cuda.synchronize()
            launched = kernels.launch_counts()[counter]
            if launched != SHARDS:
                raise AssertionError(f"sharded {kind} b={b}: {launched} launches of "
                                     f"{counter}, want {SHARDS}")
            whole, want = kernel(q, k, mask), plain(q, k, mask)
            near = kind == "bf16"
            what = f"sharded {kind} b={b}"
            err, swaps = topk_compare(f"{what} vs the unsharded kernel", q, corpus, mask,
                                      got, whole, near)
            err_p, swaps_p = topk_compare(f"{what} vs plain", q, corpus, mask, got, want, near)
            if kind == "int8" and err:
                raise AssertionError(f"{what}: scores differ from #2's by {err}")
            row = {"launches_a_call": launched, "max_abs_err_vs_kernel": err,
                   "near_tie_swaps_vs_kernel": swaps, "max_abs_err_vs_plain": err_p,
                   "near_tie_swaps_vs_plain": swaps_p,
                   "ms": median_ms(sharded), "graph_ms": graph_ms_or_none(what, sharded),
                   "unsharded_ms": median_ms(lambda: kernel(q, k, mask)),
                   "unsharded_graph_ms": graph_ms_or_none(
                       f"unsharded {kind} b={b}", lambda: kernel(q, k, mask))}
            log(f"phase 4i {what}: {json.dumps(row)}")
            out[f"{kind} b={b}"] = row
        del q50, mask, corpus, c_scale, shards, masks, scales
        free_card()
    return out


def recall_at(got_rows, exact_rows) -> float:
    return sum(len(set(g) & set(e)) for g, e in zip(got_rows, exact_rows)) / (
        len(exact_rows) * len(exact_rows[0]))


def check_ivf(gen) -> dict:
    """Phase 4i (b): IVFIndex on IVF_N clustered rows against #1's exact
    search of the same rows, and a full probe of IVF_EXACT_N rows."""
    import torch
    from ragmeup_tpu_torch.ops import topk
    from ragmeup_tpu_torch.retrieval import ivf
    centers = unit_rows(torch.randn(IVF_BLOBS, TOPK_D, generator=gen, device="cuda"))
    labels = torch.randint(0, IVF_BLOBS, (IVF_N,), generator=gen, device="cuda")
    v = unit_rows(centers[labels] + IVF_SPREAD * torch.randn(
        IVF_N, TOPK_D, generator=gen, device="cuda"))
    idx = ivf.IVFIndex(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    idx.fit(v)
    torch.cuda.synchronize()
    K, c_pad, _ = idx.buckets.shape
    res = {"n": IVF_N, "clusters": K, "c_pad": c_pad, "fit_s": time.perf_counter() - t0,
           "memory_bytes": idx.memory_bytes, "kmeans_scores_bytes": IVF_N * K * 4,
           "fit_peak_bytes_above_inputs": torch.cuda.max_memory_allocated() - base,
           "searches": {}}
    log(f"phase 4i ivf fit: {json.dumps(res)}")
    corpus = v.T.contiguous().to(torch.bfloat16)
    mask = torch.zeros(1, IVF_N, device="cuda")
    pick = torch.randperm(IVF_N, generator=gen, device="cuda")[:32]
    queries = unit_rows(v[pick] + 0.01 * torch.randn(32, TOPK_D, generator=gen, device="cuda"))
    for b in (1, 32):
        q = queries[:b]
        exact = topk.dense_topk(q, corpus, IVF_K, mask=mask)[1].tolist()
        exact_ms = median_ms(lambda: topk.dense_topk(q, corpus, IVF_K, mask=mask))
        qb = q.to(idx.buckets.dtype)
        for nprobe in (8, 32):
            def search():
                return ivf._ivf_search(qb, idx.centroids, idx.buckets, idx.row_ids,
                                       idx.valid, k=IVF_K, nprobe=nprobe)
            rows = search()[1].tolist()
            row = {"recall_at_20": recall_at(rows, exact),
                   "ms": median_ms(search, reps=5, rounds=3), "exact_topk_ms": exact_ms}
            log(f"phase 4i ivf b={b} nprobe={nprobe}: {json.dumps(row)}")
            res["searches"][f"b={b} nprobe={nprobe}"] = row
    del idx, corpus, mask
    free_card()
    sub = v[:IVF_EXACT_N].contiguous()
    small = ivf.IVFIndex(device="cuda")
    small.fit(sub)
    sub_corpus = sub.T.contiguous().to(torch.bfloat16)
    sub_mask = torch.zeros(1, IVF_EXACT_N, device="cuda")
    q = unit_rows(sub[:8] + 0.01 * torch.randn(8, TOPK_D, generator=gen, device="cuda"))
    s, r = ivf._ivf_search(q.to(torch.bfloat16), small.centroids, small.buckets,
                           small.row_ids, small.valid, k=IVF_K,
                           nprobe=small.centroids.shape[0])
    want = topk.dense_topk(q, sub_corpus, IVF_K, mask=sub_mask)
    err, swaps = topk_compare("ivf full probe vs #1", q, sub_corpus, sub_mask,
                              (s, r.to(torch.int32)), want, near_ties=True)
    if err > TOPK_NEAR_TIE:
        raise AssertionError(f"ivf full probe: scores differ from #1's by {err}")
    res["full_probe"] = {"n": IVF_EXACT_N, "clusters": small.centroids.shape[0],
                         "max_abs_err": err, "near_tie_swaps": swaps}
    log(f"phase 4i ivf full probe: {json.dumps(res['full_probe'])}")
    del v, sub, small, sub_corpus
    free_card()
    return res


def retrieval_ms(system, probes) -> float:
    """Mean ms of the retriever's hybrid search over the probe queries
    (query embedding included)."""
    import torch
    system.retriever.retrieve_rows(probes[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q in probes:
        system.retriever.retrieve_rows(q)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(probes)


def check_stream(system, encoder, texts) -> dict:
    """Phase 4i (d): STREAM_BATCHES batches of STREAM_B queries through
    hybrid_fused_search_stream, equal to hybrid_fused_search batch by
    batch, over the system's bf16 index and an int8 copy of it; each way
    timed on its second pass."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.retrieval.dense import DenseIndex
    from ragmeup_tpu_torch.retrieval.hybrid import (hybrid_fused_search,
                                                    hybrid_fused_search_stream)
    r = system.retriever
    n = STREAM_BATCHES * STREAM_B
    queries = [f"Which notes mention {' '.join(texts[i * 31 % N_DOCS].split()[:3])}?"
               for i in range(n)]
    qv = encoder.encode(queries)
    batches = [(queries[i:i + STREAM_B], qv[i:i + STREAM_B]) for i in range(0, n, STREAM_B)]
    kw = dict(weights=r.weights, rrf_c=r.rrf_c, re2_prompt=r.re2_prompt,
              search_type=r.search_type, fetch_k=r.mmr_fetch_k, mmr_lambda=r.mmr_lambda)
    int8 = DenseIndex(system.dense.dim, dtype="int8", device="cuda")
    int8.add(system.dense.host_vectors().astype("float32"))
    out = {}
    for kind, dense in (("bf16", system.dense), ("int8", int8)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = [hybrid_fused_search(dense, system.sparse, qs, v, r.k, **kw)
                    for qs, v in batches]
            seq_ms = (time.perf_counter() - t0) * 1e3
            kernels.reset_counts()
            t0 = time.perf_counter()
            got = list(hybrid_fused_search_stream(dense, system.sparse, batches, r.k, **kw))
            stream_ms = (time.perf_counter() - t0) * 1e3
        counter = "topk" if kind == "bf16" else "topk_int8"
        launched = kernels.launch_counts()[counter]
        if got != want or launched != STREAM_BATCHES:
            raise AssertionError(f"stream {kind}: equal to the per-batch search "
                                 f"{got == want}, {launched} launches of {counter}")
        out[kind] = {"batches": STREAM_BATCHES, "queries_a_batch": STREAM_B,
                     "stream_ms": stream_ms, "one_after_another_ms": seq_ms,
                     "launches": launched}
        log(f"phase 4i stream {kind}: {json.dumps(out[kind])}")
    return out


def run_retrieval_at_scale(seed: int, tmp: str, data_dir: str, index_dir: str, models,
                           texts, queries) -> dict:
    """Phase 4i (see the module docstring). Returns the runs "corpus
    sharded" and "ivf"."""
    import torch
    from ragmeup_tpu_torch.parallel.sharded_index import ShardedDenseIndex
    t_phase = time.perf_counter()
    encoder, cross, llm = models
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    readings = {"sharded_topk": check_sharded_topk(gen), "ivf": check_ivf(gen)}
    runs = {}
    copies = http_copies(tmp, data_dir, index_dir, "sharded")
    cfg = rag_config(*copies)
    cfg.generation.temperature = 0.0
    single = open_system(cfg, encoder, cross, llm)
    cfg = rag_config(*copies)
    cfg.generation.temperature = 0.0
    cfg.parallel.corpus_axis = SHARDS
    sharded = open_system(cfg, encoder, cross, llm, devices=["cuda:0"] * SHARDS)
    if not (isinstance(sharded.dense, ShardedDenseIndex)
            and len(sharded.dense._corpus_t) == SHARDS and sharded.retriever.mesh):
        raise AssertionError("corpus_axis: the system did not shard its index")
    probes = [f"Which notes mention {' '.join(texts[i].split()[:3])}?"
              for i in range(0, N_DOCS, N_DOCS // 32)]
    for q in probes:
        a = [row for row, _ in single.retriever.retrieve_rows(q)]
        b = [row for row, _ in sharded.retriever.retrieve_rows(q)]
        if a != b:
            raise AssertionError(f"corpus sharded: {q!r} retrieved {b}, one device {a}")
    readings["retrieval_ms"] = {"one_device": retrieval_ms(single, probes),
                                "corpus_sharded": retrieval_ms(sharded, probes)}
    want = single.chat(queries[0])
    runs["corpus sharded"] = drive("corpus sharded", sharded, llm, queries[:1])
    if runs["corpus sharded"]["documents"][0] != [d["pk"] for d in want["documents"]]:
        raise AssertionError(f"corpus sharded /chat fetched "
                             f"{runs['corpus sharded']['documents'][0]}, one device "
                             f"{[d['pk'] for d in want['documents']]}")
    readings["stream"] = check_stream(single, encoder, texts)
    del sharded, single
    free_card()
    cfg = rag_config(*copies)
    cfg.retrieval.ann = "ivf"
    ivf_sys = open_system(cfg, encoder, cross, llm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf_sys.retriever.retrieve_rows(probes[0])  # fits the view
    torch.cuda.synchronize()
    readings["retrieval_ms"]["ivf_first_search_with_fit"] = (time.perf_counter() - t0) * 1e3
    readings["retrieval_ms"]["ivf"] = retrieval_ms(ivf_sys, probes)
    runs["ivf"] = drive("ivf", ivf_sys, llm, queries[:1])
    del ivf_sys, llm.generate  # time_llm_calls' wrappers
    free_card()
    log(f"phase 4i retrieval ms a query: {json.dumps(readings['retrieval_ms'])}")
    log(f"phase 4i: {time.perf_counter() - t_phase:.1f} s")
    runs["corpus sharded"]["readings"] = readings
    return runs

# ---------------------------------------------------------------------------
# phase 4j: the model axis
# ---------------------------------------------------------------------------

MODEL_SHARDS = 4        # the 8B's model-axis shards, all on cuda:0
# caps on the sharded decoder's logits against the one-device decoder's on
# the same weights: (largest |difference|, mean |difference|, least cosine).
# Each psum rounds the shards' bf16 partials and sums where one device
# rounds its product once; the gap is rounding noise, spread over the whole
# vocabulary (largest about six times the mean), where a sharding fault
# moves the mean with the largest. Derived before the call from the
# prefill readings of earlier calls (PERF.md §6, PR 20), with room for the
# decode steps' other routes (k_proj and v_proj off #3 on a shard)
TP_CAPS = {"8b": (0.6, 0.1, 0.995),       # Llama-3.1-8B, 32 layers
           "moe": (0.2, 0.035, 0.9995)}   # Mixtral-8x7B, 2 layers
TP_PROMPT = 1000        # tokens of the prompt whose logits are held
TP_STEPS = 16           # decode steps fed the one-device greedy stream
TP_NEW_TOKENS = 8       # generation.max_new_tokens of phase 4j's requests


def model_mesh(corpus: int, model: int):
    from ragmeup_tpu_torch.parallel.mesh import make_mesh
    return make_mesh((1, corpus, model), devices=["cuda:0"] * (corpus * model))


def by_shard() -> dict:
    """kernels.shard_counts() as {kernel: [launches of shard 0, 1, ...]}."""
    from ragmeup_tpu_torch import kernels
    out = {}
    for key, n in kernels.shard_counts().items():
        name, _, shard = key.rpartition(" shard=")
        row = out.setdefault(name, [])
        row.extend([0] * (int(shard) + 1 - len(row)))
        row[int(shard)] = n
    return out


def count_forwards(llm) -> dict:
    """Count the LLM's dense-cache forwards from now on: decode steps and
    verify forwards (at most 8 rows: #3 and #4 at decode shapes), prefills,
    and prefills of at most 256 rows (#4's kernel route)."""
    seen = {"forwards": 0, "prefills": 0, "prefills_le_256": 0}
    verify, prefill = llm._verify, llm._prefill

    def counted_verify(chunk, p0, caches):
        seen["forwards"] += 1
        return verify(chunk, p0, caches)

    def counted_prefill(ids, length, cache_len):
        seen["prefills"] += 1
        seen["prefills_le_256"] += int(ids.shape[1] <= 256)
        return prefill(ids, length, cache_len)
    llm._verify, llm._prefill = counted_verify, counted_prefill
    return seen


def check_shard_launches(label: str, want: dict, shards: int) -> dict:
    """The launches of this run by kernel and shard (read just after it)
    against the counts predicted for every shard."""
    got = by_shard()
    log(f"{label}: launches by shard {json.dumps(got)}; predicted for each of the "
        f"{shards} shards {json.dumps(want)}")
    for name, n in want.items():
        if got.get(name) != [n] * shards:
            raise AssertionError(f"{label}: {name} launched {got.get(name)} by shard, "
                                 f"predicted {n} on each of {shards}")
    return got


def weight_gib(llm) -> float:
    """GiB of the LLM's weights (and widened heads) on the card, each
    storage once: shards on one device share their replicated tensors."""
    held = {}
    for m in getattr(llm.model, "shards", [llm.model]):
        tensors = list(m.state_dict().values())
        if m._head_f32 is not None:
            tensors.append(m._head_f32)
        for t in tensors:
            held[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(held.values()) / 2**30


def check_shards(sharded, one, layers) -> int:
    """The sharded LLM's tensors of ``layers``, the embedding, the final
    norm and the head torch.equal to the shards that tp_shard_model cuts
    from the one-device LLM's."""
    import torch
    from ragmeup_tpu_torch.parallel import tp
    c = one.cfg
    n = sharded.mesh.shape["model"]
    specs = tp.model_param_shardings(c, sharded.mesh, shard_vocab=True)
    full = one.model.state_dict()
    keys = [k for k in full if not k.startswith("layers.")
            or int(k.split(".")[1]) in layers]
    for i, shard in enumerate(sharded.model.shards):
        got = shard.state_dict()
        for k in keys:
            spec = specs[k]
            want = (tp._shard_of(k, full[k], spec.index("model"), i, n, c)
                    if "model" in spec else full[k])
            if not torch.equal(got[k], want):
                raise AssertionError(f"shard {i} of {k} differs from the one-device cut")
    return len(keys) * n


def logit_diff(label: str, a, b, caps) -> dict:
    """Two logit vectors (the one-device decoder's, the sharded one's) held
    within ``caps`` (TP_CAPS: largest and mean |difference|, cosine)."""
    import torch
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{label}: non-finite logits")
    d = (a - b).abs()
    res = {"max_abs_logit_diff": d.max().item(), "mean_abs_logit_diff": d.mean().item(),
           "cosine": torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
           "max_abs_logit": a.abs().max().item()}
    if (res["max_abs_logit_diff"] > caps[0] or res["mean_abs_logit_diff"] > caps[1]
            or res["cosine"] < caps[2]):
        raise AssertionError(f"{label}: sharded logits off the one-device ones: "
                             f"{json.dumps(res)}, caps {caps}")
    return res


def logit_gap(label: str, one, sharded, ids, caps) -> dict:
    """Prefill logits of ``ids`` through the sharded decoder against the
    one-device one, within ``caps``."""
    res = logit_diff(label, one.forward_logits(ids), sharded.forward_logits(ids), caps)
    res.update(prompt_tokens=len(ids), caps=caps)
    log(f"{label}: prefill logits against one device {json.dumps(res)}")
    return res


def teacher_forced(label: str, one, sharded, ids, n: int, caps) -> dict:
    """The one-device decoder's greedy stream of ``n`` tokens (repetition
    penalty 1.0; equal to its ``generate``) fed through both decoders: the
    prefill's logits and those of each of the n - 1 decode steps (the
    sharded decoder's per-shard dense caches) held within ``caps``. At
    each step the sharded decoder's own greedy pick must be the stream's
    token or a near-tie: the one-device margin between the two tokens at
    most twice that step's largest |difference|."""
    import torch
    L = len(ids)
    cache_len = one._bucket(L + n)
    logits, runs = {}, []
    with torch.inference_mode():
        for name, llm in (("one", one), ("sharded", sharded)):
            first, caches = llm._prefill(llm._padded(ids, llm._bucket(L)), L, cache_len)
            logits[name] = [first.float()]
            runs.append((name, llm, caches))
        stream = []
        for i in range(n):
            stream.append(int(logits["one"][-1].argmax()))
            if i < n - 1:
                for name, llm, caches in runs:
                    logits[name].append(llm._decode(stream[-1], L + i, caches).float())
    want = one.generate(ids, max_new_tokens=n, temperature=0.0, repetition_penalty=1.0,
                        speculative="off")
    if want != stream:
        raise AssertionError(f"{label}: the teacher-forced stream {stream} is not "
                             f"generate's {want}")
    steps = [logit_diff(f"{label} step {i}", a, b, caps)
             for i, (a, b) in enumerate(zip(logits["one"], logits["sharded"]))]
    res = {"prompt_tokens": L, "steps": n, "caps": caps,
           "max_abs_logit_diff": [s["max_abs_logit_diff"] for s in steps],
           "mean_abs_logit_diff": [s["mean_abs_logit_diff"] for s in steps],
           "min_cosine": min(s["cosine"] for s in steps), "picks_equal": 0,
           "near_ties": []}
    for i, (a, b) in enumerate(zip(logits["one"], logits["sharded"])):
        pick = int(b.argmax())
        if pick == stream[i]:
            res["picks_equal"] += 1
            continue
        margin = (a[stream[i]] - a[pick]).item()
        res["near_ties"].append([i, margin])
        if margin > 2 * steps[i]["max_abs_logit_diff"]:
            raise AssertionError(f"{label}: the sharded pick differs at step {i} with "
                                 f"margin {margin}, not a near-tie")
    log(f"{label}: {n} teacher-forced steps against one device {json.dumps(res)}")
    return res


def greedy_parted(label: str, one, ids, want, got, gap: float) -> dict:
    """The sharded decoder's greedy tokens ``got`` against the one-device
    stream ``want`` on the prompt ``ids``: equal, or equal up to a first
    difference where the one-device logits' margin between the two tokens
    is at most twice the measured prefill gap (a near-tie)."""
    res = {"tokens": len(want), "equal": want == got}
    if want != got:
        i = next((j for j in range(min(len(want), len(got))) if want[j] != got[j]), None)
        if i is None:
            raise AssertionError(f"{label}: greedy streams of {len(want)} and {len(got)} "
                                 f"tokens")
        lg = one.forward_logits(list(ids) + want[:i])
        res.update(first_difference=i, margin=float(lg[want[i]] - lg[got[i]]))
        if res["margin"] > 2 * gap:
            raise AssertionError(f"{label}: greedy tokens part at {i} with margin "
                                 f"{res['margin']}, not a near-tie")
    log(f"{label}: {len(want)} greedy tokens against one device {json.dumps(res)}")
    return res


def run_moe_ep(seed: int, quantization: str) -> dict:
    """Phase 4j (d): Mixtral-8x7B's shape at full width and two layers,
    drawn on the card, on one device and over a 4-way model axis (2 experts
    a shard) on the same weights: prefill logits held; 8 greedy tokens one
    a forward on one device, then on the mesh with the launch counts reset
    just before and read just after (the run's time and counts are the
    mesh's alone), each decode step through the expert-parallel gather on
    every shard (#10 for int8 experts, #13 for int4); the streams held."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.models.decoder import LlamaConfig, LocalLLM, init_decoder_params
    from ragmeup_tpu_torch.models.hf_loader import select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    label = f"moe ep {quantization}"
    cfg = select_kernels(LlamaConfig.mixtral_8x7b(num_layers=2, quantization=quantization))
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    params = init_decoder_params(cfg, gen, "cuda")
    tok = SimpleTokenizer(cfg.vocab_size)
    one = LocalLLM(cfg, tok, params=dict(params), eos_ids=(2,), device="cuda")
    ep = LocalLLM(cfg, tok, params=params, eos_ids=(2,), mesh=model_mesh(1, MODEL_SHARDS))
    prompt = list(range(100, 228))
    res = {"logits": logit_gap(label, one, ep, prompt, TP_CAPS["moe"])}
    kw = dict(max_new_tokens=8, temperature=0.0, repetition_penalty=1.0, speculative="off")
    want = one.generate(prompt, **kw)
    torch.cuda.synchronize()
    kernels.reset_counts()
    fw = count_forwards(ep)
    t0 = time.perf_counter()
    got = ep.generate(prompt, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = kernels.launch_counts()
    gather = "moe_gather_int4" if quantization == "int4" else "moe_gather"
    # each decode step, on each shard: gate, up and down of 2 layers through
    # the gather; q_proj and o_proj of 2 layers through #3 / #4 (k_proj and
    # v_proj have 256 local columns: the fallback); #4 also in the 128-row prefill
    pred = {gather: 6 * fw["forwards"]}
    if quantization == "int4":
        pred["int4_matmul"] = 4 * (fw["forwards"] + fw["prefills_le_256"])
    else:
        pred["int8_matmul"] = 4 * fw["forwards"]
    res["by_shard"] = check_shard_launches(label, pred, MODEL_SHARDS)
    res["forwards"] = dict(fw)
    res["greedy"] = greedy_parted(label, one, prompt, want, got,
                                  res["logits"]["max_abs_logit_diff"])
    del one, ep, params
    free_card()
    return {"counts": counts, "latency_s": [sec], "readings": res}


def run_model_axis(seed: int, tmp: str, data_dir: str, index_dir: str, models, ckpt_llm: str,
                   queries, first_turns) -> dict:
    """Phase 4j (see the module docstring). Returns the runs "tp4", "tp4
    batched", "ring", "moe ep int8", "moe ep int4" and "tp4 w4a16"."""
    import torch
    from ragmeup_tpu_torch.models import decoder
    t_phase = time.perf_counter()
    encoder, cross, llm = models
    L = llm.cfg.num_layers
    gen = torch.Generator().manual_seed(seed + 23)
    ids = torch.randint(4, 30000, (TP_PROMPT,), generator=gen).tolist()
    copies = http_copies(tmp, data_dir, index_dir, "model_axis")
    devices = ["cuda:0"] * MODEL_SHARDS
    readings, runs = {}, {}

    def config(**parallel):
        # the answers cut to TP_NEW_TOKENS and the rewrite loop off (one
        # generation a first turn): the shards' layers run one after
        # another on the one card, each decode step about four one-device
        # steps of host work
        cfg = rag_config(*copies)
        cfg.generation.max_new_tokens = TP_NEW_TOKENS
        cfg.pipeline.use_rewrite_loop = False
        for name, value in parallel.items():
            setattr(cfg.parallel, name, value)
        return cfg

    # (a) the 8B int8 from phase 4's checkpoint over 4 model shards
    before = torch.cuda.memory_allocated() / 2**30
    cfg = config(model_axis=MODEL_SHARDS)
    cfg.model.llm_checkpoint = ckpt_llm
    system = open_system(cfg, encoder, cross, devices=devices)
    tp4 = system.llm
    if not (isinstance(tp4.model, decoder.ShardedLlamaModel)
            and len(tp4.model.shards) == MODEL_SHARDS and tp4.eos_ids == llm.eos_ids):
        raise AssertionError("model_axis: RagSystem did not shard its LLM")
    n = check_shards(tp4, llm, (0, L // 2, L - 1))
    readings["tp4 teacher forced"] = teacher_forced("tp4", llm, tp4, ids, TP_STEPS,
                                                    TP_CAPS["8b"])
    readings["gib"] = {"one_device_llm_weights": weight_gib(llm),
                       "tp4_llm_weights": weight_gib(tp4), "allocated_before": before,
                       "allocated_after": torch.cuda.memory_allocated() / 2**30}
    log(f"tp4: {n} shard tensors torch.equal to the one-device cut; GiB "
        f"{json.dumps(readings['gib'])}")
    fw = count_forwards(tp4)
    runs["tp4"] = drive("tp4", system, tp4, queries)
    # q, o, gate, up and down through #3 at every decode step; k_proj and
    # v_proj (256 local columns) take the dequantized fallback
    readings["tp4 by shard"] = check_shard_launches(
        "tp4", {"int8_matmul": 5 * L * fw["forwards"], "flash_gqa": L * fw["prefills"]},
        MODEL_SHARDS)
    readings["tp4 forwards"] = dict(fw)
    del tp4._verify, tp4._prefill

    # (b) four concurrent requests through the engine on per-shard pools
    cfg = config(model_axis=MODEL_SHARDS)
    cfg.server.batched_llm = True
    batched = open_system(cfg, encoder, cross, tp4, devices=devices)
    if not (isinstance(batched.backend.engine.cache.k_pages[0], list)
            and batched.backend.engine.cache.k_pages[0][0].shape[0] == 2):
        raise AssertionError("tp4 batched: the pools are not held per shard")
    runs["tp4 batched"] = drive_batched(batched, first_turns, label="tp4 batched")
    got = by_shard()
    log(f"tp4 batched: launches by shard {json.dumps(got)}")
    for name in ("int8_matmul", "paged_attention", "paged_attention_chunk"):
        row = got.get(name, [])
        if len(row) != MODEL_SHARDS or len(set(row)) != 1 or row[0] % L:
            raise AssertionError(f"tp4 batched: {name} by shard {row}")
    readings["tp4 batched by shard"] = got
    del batched, system, tp4
    free_card()

    # (c) the ring prefill: corpus 2 x model 2, from the one-device weights
    ring_llm = decoder.LocalLLM(llm.cfg, llm.tokenizer, params=llm.model.state_dict(),
                                eos_ids=llm.eos_ids, mesh=model_mesh(2, 2))
    ring_calls = []
    ring = decoder.ring_attention
    decoder.ring_attention = lambda *a, **kw: (ring_calls.append(1), ring(*a, **kw))[1]
    try:
        readings["ring logits"] = logit_gap("ring", llm, ring_llm, ids, TP_CAPS["8b"])
        if len(ring_calls) != 2 * L:
            raise AssertionError(f"ring: {len(ring_calls)} ring calls in one prefill")
        ring_sys = open_system(config(corpus_axis=2, model_axis=2), encoder, cross,
                               ring_llm, devices=devices)
        ring_calls.clear()
        fw = count_forwards(ring_llm)
        runs["ring"] = drive("ring", ring_sys, ring_llm, queries[:1])
    finally:
        decoder.ring_attention = ring
    if runs["ring"]["counts"]["flash_gqa"] or len(ring_calls) != 2 * L * fw["prefills"]:
        raise AssertionError(f"ring: flash launched {runs['ring']['counts']['flash_gqa']} "
                             f"times, {len(ring_calls)} ring calls for {fw['prefills']} "
                             f"prefills")
    # at 2 shards k_proj and v_proj keep 512 local columns: all 7 on #3
    readings["ring"] = {"ring_calls": len(ring_calls), "forwards": dict(fw),
                        "by_shard": check_shard_launches(
                            "ring", {"int8_matmul": 7 * L * fw["forwards"]}, 2)}
    del ring_sys, ring_llm
    free_card()

    # (d) Mixtral-8x7B's shape, 2 experts a shard: the expert-parallel gather
    for quantization in ("int8", "int4"):
        run = run_moe_ep(seed, quantization)
        readings[f"moe ep {quantization}"] = run.pop("readings")
        runs[f"moe ep {quantization}"] = run

    # (e) the 8B W4A16 from the checkpoint over 4 model shards
    cfg = config(model_axis=MODEL_SHARDS)
    cfg.model.llm_checkpoint = ckpt_llm
    cfg.model.quantization = "int4"
    system = open_system(cfg, encoder, cross, devices=devices)
    w4 = system.llm
    fw = count_forwards(w4)
    runs["tp4 w4a16"] = drive("tp4 w4a16", system, w4, queries[:1])
    # the five projections that pass the local gate at decode rows and at
    # prefills of at most 256 rows; k_proj and v_proj take the fallback
    readings["tp4 w4a16 by shard"] = check_shard_launches(
        "tp4 w4a16", {"int4_matmul": 5 * L * (fw["forwards"] + fw["prefills_le_256"]),
                      "flash_gqa": L * fw["prefills"]}, MODEL_SHARDS)
    del system, w4
    free_card()
    log(f"phase 4j: {time.perf_counter() - t_phase:.1f} s")
    runs["tp4"]["readings"] = readings
    return runs


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_system(seed: int) -> dict:
    """The runs of requests; returns each run's counts and latencies."""
    import shutil
    import torch
    from ragmeup_tpu_torch.models.decoder import LlamaConfig
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        texts = write_corpus(data_dir, N_DOCS, seed)
        words = texts[7].split()
        queries = [f"What do the notes say about {' '.join(words[:3])}?",
                   f"Which notes mention {' '.join(texts[4242].split()[:2])}?",
                   "Tell me more about that."]
        ckpt_root = os.path.join(tmp, "checkpoints")
        check_tokenizer_goldens()
        ckpts = write_checkpoints(ckpt_root, seed)

        system = open_system(with_checkpoints(
            rag_config(data_dir, os.path.join(tmp, "index")), ckpts))
        llm, encoder, cross = system.llm, system.encoder, system.cross_encoder
        check_tokenizers({"gist_small embedder": encoder.tokenizer,
                          "minilm_l6_cross reranker": cross.tokenizer,
                          "llama31_8b": llm.tokenizer})
        check_8b_checkpoint(llm, ckpts["llm"])
        prompt_calls = []
        with timed_encodes(llm.tokenizer, prompt_calls):
            runs["default"] = drive("default", system, llm, queries)
        tokenizer_host_times(ckpts, texts, queries[0], prompt_calls)
        random_llm = build_llm(seed, LlamaConfig.llama31_8b())
        system = open_system(rag_config(data_dir, os.path.join(tmp, "index")), encoder, cross,
                             random_llm)
        runs["default random"] = drive("default random", system, random_llm, queries)
        del system, random_llm
        free_card()
        cfg = rag_config(data_dir, os.path.join(tmp, "index"))
        cfg.server.batched_llm = True
        batched = open_system(cfg, encoder, cross, llm)
        first_turns = queries[:2] + [
            f"What is {' '.join(texts[99].split()[:2])}?",
            f"Summarize the notes on {' '.join(texts[12000].split()[:3])}."]
        runs["batched"] = drive_batched(batched, first_turns)
        del batched
        mark("phases 4 and 6")
        runs.update(run_greedy(seed, llm, encoder, cross, data_dir,
                               os.path.join(tmp, "index"), queries, first_turns))
        mark("phase 6b")
        runs.update(run_http(tmp, data_dir, os.path.join(tmp, "index"),
                             (encoder, cross, llm), ckpts["llm"], queries, first_turns,
                             runs["default"]["latency_s"]))
        mark("phase 4h")
        runs.update(run_retrieval_at_scale(seed, tmp, data_dir, os.path.join(tmp, "index"),
                                           (encoder, cross, llm), texts, queries))
        mark("phase 4i")
        runs.update(run_model_axis(seed, tmp, data_dir, os.path.join(tmp, "index"),
                                   (encoder, cross, llm), ckpts["llm"], queries,
                                   first_turns))
        mark("phase 4j")
        del llm
        free_card()

        index_q = os.path.join(tmp, "index_int8")
        cfg = with_checkpoints(rag_config(data_dir, index_q, quantization="int4"), ckpts)
        system = open_system(cfg, encoder, cross)
        llm = system.llm
        check_tokenizers({"llama31_8b int4": llm.tokenizer})
        check_8b_checkpoint(llm, ckpts["llm"])
        runs["int4 W4A16"] = drive("int4 W4A16", system, llm, queries)
        codes = system.dense._corpus_t[:, :N_DOCS].clone()
        scales = system.dense._scales[:, :N_DOCS].clone()
        del system, llm
        free_card()

        cfg = with_checkpoints(rag_config(data_dir, index_q, quantization="int4",
                                          int4_w4a8=True), ckpts)
        system = open_system(cfg, encoder, cross)
        llm = system.llm
        check_tokenizers({"llama31_8b W4A8": llm.tokenizer})
        check_8b_checkpoint(llm, ckpts["llm"])
        if not (torch.equal(system.dense._corpus_t[:, :N_DOCS], codes)
                and torch.equal(system.dense._scales[:, :N_DOCS], scales)):
            raise AssertionError("the reloaded int8 artifact changed the codes")
        runs["int4 W4A8"] = drive("int4 W4A8", system, llm, queries[1:2])
        del system, llm
        free_card()
        shutil.rmtree(ckpts["llm"])
        mark("phase 5")

        runs.update(run_gemma2(seed, ckpt_root, data_dir, os.path.join(tmp, "index"),
                               queries, first_turns, encoder, cross))
        mark("phase 5c")
        runs.update(run_moe_checkpoint(ckpt_root, seed))
        runs.update(run_family_checkpoints(ckpt_root, seed))
        mark("phases 5b and 5d")
        for phase, done in ((run_moe, "phase 7"), (run_moe_int4, "phase 8")):
            runs.update(phase(seed, encoder, cross, data_dir, os.path.join(tmp, "index"),
                              texts, queries))
            mark(done)
        del encoder, cross
        free_card()
        runs.update(run_training(seed, ckpt_root))
        mark("phase 9")
        shutil.rmtree(ckpt_root)
    return runs


def eight_first_turns(texts, queries) -> list:
    """The batched MoE runs' eight concurrent first turns."""
    return queries[:2] + [
        f"What is {' '.join(texts[i].split()[:2])}?" for i in (99, 555, 2024, 7777)] + [
        f"Summarize the notes on {' '.join(texts[i].split()[:3])}."
        for i in (12000, 15000)]


def moe_layer_kernels(llm, tokens: int, want: str) -> list:
    """The rk_ kernels the decoder's first MoE MLP launches
    (torch.profiler) on `tokens` random rows: one token is a decode step
    (the per-slot gather, #10), 8 a batched wave (the dedup route, #11).
    Raises unless `want` is among them (kernels_of_retraced)."""
    import torch
    from ragmeup_tpu_torch.models.decoder import LlamaMoeMlp
    mlp = next(layer.mlp for layer in llm.model.layers if isinstance(layer.mlp, LlamaMoeMlp))
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    x = torch.randn(1, tokens, llm.cfg.hidden_size, generator=gen, device="cuda").to(
        llm.cfg.torch_dtype)
    with torch.inference_mode():
        found = kernels_of_retraced(lambda: mlp(x))
    log(f"  an MoE layer at {tokens} token(s) launches {found}")
    if want not in found:
        raise AssertionError(f"an MoE layer at {tokens} token(s) launched {found}, not {want}")
    return found


def run_moe(seed: int, encoder, cross, data_dir: str, index_dir: str, texts,
            queries) -> dict:
    """Phase 7 on the Mixtral-8x7B-shaped int8 decoder (MOE_SMOKE_LAYERS
    layers, 24 GB), with the
    bf16 index of phase 4: three requests on the default config; one on a
    second decoder over the same weights (shared storage) with
    moe_grouped="on"; eight first turns at once through the paged engine,
    then a follow-up."""
    import dataclasses
    from ragmeup_tpu_torch.models.decoder import LlamaConfig, LocalLLM
    runs = {}
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b(num_layers=MOE_SMOKE_LAYERS))
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, llm)
    runs["moe"] = drive("moe", system, llm, queries)
    # the kernels "moe" (a decode step) and "moe batched" (a wave of 8 rows)
    # run in an MoE layer of this decoder
    moe_layer_kernels(llm, 1, "rk_moe_gather_stream_kernel")
    moe_layer_kernels(llm, 8, "rk_moe_grouped_mma_kernel")
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
    (group 128; MOE_SMOKE_LAYERS layers, about 13 GB), with the bf16 index of phase 4: three
    requests on the default config ("moe int4": decode through #13); the
    paged engine on the same decoder with eight first turns at once and a
    follow-up ("moe int4 batched": 8-row waves through #14); then a W4A8
    decoder (512-row groups: #5 and the output-scaled route of #13) answers
    one ("moe int4 W4A8")."""
    from ragmeup_tpu_torch.models.decoder import LlamaConfig
    runs = {}
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b(num_layers=MOE_SMOKE_LAYERS,
                                                   quantization="int4"))
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
    llm = build_llm(seed, LlamaConfig.mixtral_8x7b(num_layers=MOE_SMOKE_LAYERS,
                                                   quantization="int4", int4_w4a8=True))
    system = open_system(rag_config(data_dir, index_dir), encoder, cross, llm)
    runs["moe int4 W4A8"] = drive("moe int4 W4A8", system, llm, queries[1:2])
    del system, llm
    free_card()
    return runs


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 512   # a train batch: rows and tokens a row
TRAIN_STEPS = 3
TRAIN_LR = 1e-4             # the JAX package's default decoder learning rate
TRAIN_RESUME_REL = 1e-5     # the resumed step's loss against the uninterrupted step's
TRAIN_RESUME_ATOL = 1e-7    # the weights after it (a lost moment moves them ~TRAIN_LR)
BWD_TOL = 1e-2              # the grouped backward against plain autograd, relative to
#                             the plain result's largest |value| (bf16 outputs, f32 sums
#                             in another order)
TRAIN_SERVE_TOKENS = 8


def train_batch(gen, vocab: int) -> dict:
    """TRAIN_B rows of TRAIN_S token ids drawn on the card; the second row's
    last quarter masked out of the loss."""
    import torch
    ids = torch.randint(0, vocab, (TRAIN_B, TRAIN_S), generator=gen, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, TRAIN_S * 3 // 4:] = 0
    return {"ids": ids, "mask": mask}


def train_steps(label: str, state, step, batch, n: int):
    """n steps, each timed to its end: its metrics, ms and tokens/s."""
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        r = {k: float(v) for k, v in metrics.items()}
        r.update(ms=round(sec * 1e3, 1),
                 tokens_per_s=round(batch["ids"].numel() / sec, 1))
        log(f"{label} step {state.step}: {json.dumps(r)}")
        out.append(r)
    losses = [r["loss"] for r in out]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} not finite and falling")
    return state, out


def train_run(label: str, steps: list, counts: dict, variants: dict, **readings) -> dict:
    """A run of train steps in the shape of the /chat runs (its seconds a
    step as latency_s), every kernel of its path launched."""
    missing = missing_kernels(label, counts, variants)
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    log(f"{label}: launch counts over its {len(steps)} steps: "
        f"{ {k: v for k, v in counts.items() if v} }; by variant: {variants}")
    return {"counts": counts, "variants": variants, "latency_of": "seconds a train step",
            "latency_s": [r["ms"] / 1e3 for r in steps], "readings": dict(readings, steps=steps)}


def run_train_8b(seed: int, root: str) -> dict:
    """Phase 9 (1) and (4): the Llama-3.1-8B-shaped decoder at full width
    and two layers, f32 weights computed in bf16, TRAIN_STEPS AdamW steps
    ("train 8b": no CUDA kernel of the port is on this path: the einsum
    attention, float projections); saved at the last step, one more step
    taken, then a fresh template restored from the checkpoint takes the
    same step (its loss within TRAIN_RESUME_REL, every weight after it
    within TRAIN_RESUME_ATOL of the uninterrupted run's); the restored weights
    quantized int8 and served through LocalLLM for TRAIN_SERVE_TOKENS
    greedy tokens ("train serve": #8 prefill, #3 decode)."""
    import shutil
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.models.decoder import LlamaConfig, LocalLLM
    from ragmeup_tpu_torch.models.hf_loader import quantize_decoder_params, select_kernels
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    from ragmeup_tpu_torch.train import checkpoint
    from ragmeup_tpu_torch.train.train import make_decoder_train_step
    runs = {}
    cfg = LlamaConfig.llama31_8b(num_layers=2, quantization="none")
    batch = train_batch(torch.Generator(device="cuda").manual_seed(seed + 41), cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step = make_decoder_train_step(cfg, learning_rate=TRAIN_LR, seed=seed,
                                          device="cuda")
    n_params = sum(t.numel() for t in state.params.values())
    log(f"train 8b: {n_params / 1e9:.3f} B f32 parameters built in "
        f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_B} x {TRAIN_S}")
    kernels.reset_counts()
    state, steps = train_steps("train 8b", state, step, batch, TRAIN_STEPS)
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train 8b: peak {peak:.2f} GiB allocated")
    ckpt = os.path.join(root, "train_8b")
    t0 = time.perf_counter()
    path = checkpoint.save_train_state(ckpt, state)
    save_s = time.perf_counter() - t0
    gb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9
    latest = checkpoint.latest_checkpoint(ckpt)
    if not latest or not latest.endswith(f"step_{TRAIN_STEPS}"):
        raise AssertionError(f"train 8b: latest checkpoint {latest}")
    state, straight = step(state, batch)
    straight = float(straight["loss"])
    want = state.params  # the uninterrupted run's weights after its next step
    del state, step
    free_card()
    tpl, step2 = make_decoder_train_step(cfg, learning_rate=TRAIN_LR, seed=seed + 1,
                                         device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore_train_state(path, tpl)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if restored.step != TRAIN_STEPS:
        raise AssertionError(f"train 8b: restored step {restored.step}")
    after, resumed = step2(restored, batch)
    resumed = float(resumed["loss"])
    rel = abs(resumed - straight) / abs(straight)
    # the step's update reads the restored AdamW moments and step count
    drift = max((after.params[k] - w).abs().max().item() for k, w in want.items())
    del after, want
    log(f"train 8b: checkpoint {gb:.2f} GB written in {save_s:.1f} s "
        f"({gb / save_s:.2f} GB/s), read onto the card in {load_s:.1f} s "
        f"({gb / load_s:.2f} GB/s); step {TRAIN_STEPS + 1} loss uninterrupted "
        f"{straight:.6f}, resumed {resumed:.6f} (relative {rel:.2e}); the weights "
        f"after it: largest |resumed - uninterrupted| {drift:.3e} "
        f"(tolerance {TRAIN_RESUME_ATOL})")
    if rel > TRAIN_RESUME_REL or drift > TRAIN_RESUME_ATOL:
        raise AssertionError(f"train 8b: resumed loss {resumed} against {straight}, "
                             f"weights {drift} apart")
    runs["train 8b"] = train_run(
        "train 8b", steps, counts, variants, params_b=round(n_params / 1e9, 4),
        peak_gib=round(peak, 2), checkpoint_gb=round(gb, 3), save_s=round(save_s, 2),
        load_s=round(load_s, 2), loss_uninterrupted=straight, loss_resumed=resumed,
        resumed_weights_max_abs_diff=drift)
    qparams = quantize_decoder_params({k: v.detach() for k, v in restored.params.items()},
                                      bits=8)
    del tpl, step2, restored
    free_card()
    shutil.rmtree(ckpt)
    qcfg = select_kernels(LlamaConfig.llama31_8b(num_layers=2))
    llm = LocalLLM(qcfg, SimpleTokenizer(qcfg.vocab_size), params=qparams, device="cuda")
    prompt = list(range(1000, 1128))
    kernels.reset_counts()
    t0 = time.perf_counter()
    ids = llm.generate(prompt, max_new_tokens=TRAIN_SERVE_TOKENS, temperature=0.0,
                       speculative="off")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    log(f"train serve: {len(ids)} greedy tokens from the restored weights (int8) in "
        f"{sec * 1e3:.1f} ms: {list(ids)}")
    if len(ids) != TRAIN_SERVE_TOKENS:
        raise AssertionError(f"train serve: {len(ids)} tokens")
    missing = missing_kernels("train serve", counts, variants)
    if missing:
        raise AssertionError(f"train serve: kernels never launched on the path: {missing}")
    runs["train serve"] = {"counts": counts, "variants": variants, "latency_s": [sec],
                           "latency_of": f"seconds of {TRAIN_SERVE_TOKENS} greedy tokens"}
    del llm, qparams
    free_card()
    return runs


def rel_err(got, want) -> tuple:
    """(largest |got - want|, that over the largest |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def check_grouped_backward(gen) -> dict:
    """Phase 9 (3): ``GroupedKernelPath`` at one Mixtral layer's training
    shapes (TRAIN_B x TRAIN_S tokens, top-2: 2,048 bf16 rows over 8 f32
    stacks, up 4096 x 14336 and down 14336 x 4096). Forward, dx and dw
    through autograd held to autograd through the plain version
    (``moe_grouped_matmul_plain``), and each kernel call alone to its
    plain version on the same inputs: the forward (#12's stack kernel over
    f32 stacks), dx on the stacks as they lie (its dx orientation) against
    the plain product over the transposed copy, dw (csrc/moe_wgrad.cu)
    against ``grouped_weight_grad_plain``, each within BWD_TOL. Every
    kernel each call launches (profiler; dx must launch no copy: its peak
    allocation stays below a quarter of the stacks' bytes). Times: the
    forward eager and in a graph; dx, dw and the backward (dx and dw) in a
    graph; forward + backward through autograd, the plain forward and the
    plain forward + backward eager (the plain version reads the group sizes
    on the host); the yardsticks ``torch._grouped_mm`` on stacks cast to
    bf16 ahead (the same function over bf16 stacks), the cast alone, a
    cast into the layout that call takes plus the call in a graph, and
    ``_grouped_mm``'s wgrad (x^T dy over the groups, bf16 output: not the
    same function). Last, #11's grouped-rows kernel over f32 stacks at 16
    rows (the dedup route still reaches it) against its plain version; one
    call must count one launch, and a trace that names any rk_ kernel must
    name rk_moe_grouped_mma_kernel (csrc/moe_matmul.cu's rk_moe_grouped_rows
    launches that kernel alone, and its wrapper counts "moe_grouped w=f32"
    once the launch returned; traces of this call have named no rk_ kernel
    at all in some runs, six traces in a row)."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import moe_matmul as mm
    e, h, f = MOE_E, 4096, 14336
    m = 2 * TRAIN_B * TRAIN_S
    ids = torch.randint(0, e, (m,), generator=gen, device="cuda")
    gsz = torch.bincount(ids, minlength=e)
    offs = torch.cumsum(gsz, 0).to(torch.int32)
    shapes, worst = {}, (0.0, 0.0)
    wg_worst = (0.0, 0.0)
    fast = dict(reps=2, rounds=3, warm_rounds=3)
    for proj, (k, n) in (("up", (h, f)), ("down", (f, h))):
        x = (torch.randn(m, k, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        w = torch.randn(e, k, n, generator=gen, device="cuda") * 0.02
        dy = (torch.randn(m, n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = mm.moe_grouped_matmul(xk, wk, gsz)
        if "GroupedKernelPath" not in type(y.grad_fn).__name__:
            raise AssertionError(f"grouped backward {proj}: {type(y.grad_fn).__name__}")
        y.backward(dy)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        yp = mm.moe_grouped_matmul_plain(xp, wp, gsz)
        yp.backward(dy)
        errs = {"forward": rel_err(y, yp), "dx": rel_err(xk.grad, xp.grad),
                "dw": rel_err(wk.grad, wp.grad)}
        del xk, wk, xp, wp, y, yp
        wt = w.transpose(1, 2)

        def fwd():
            return mm.moe_grouped_matmul(x, w, gsz)

        def dx():
            return mm.moe_grouped_matmul(dy, wt, gsz)

        def dw():
            return mm.grouped_weight_grad(x, dy, gsz, e)

        def bwd():
            return dx(), dw()
        # each call alone against its plain version on the same inputs
        errs["forward kernel"] = rel_err(fwd(), mm.moe_grouped_matmul_plain(x, w, gsz))
        errs["dx kernel"] = rel_err(dx(), mm.moe_grouped_matmul_plain(dy, wt.contiguous(), gsz))
        wgot = dw()
        wwant = mm.grouped_weight_grad_plain(x, dy, gsz, e)
        errs["dw kernel"] = rel_err(wgot, wwant)
        del wgot, wwant
        log(f"  grouped backward {proj}: largest |error| (relative to the plain result's "
            f"largest |value|): " + ", ".join(f"{name} {a:.3e} ({r:.2e})"
                                              for name, (a, r) in errs.items())
            + f"; tolerance {BWD_TOL} relative")
        for name, (a, r) in errs.items():
            if r > BWD_TOL:
                raise AssertionError(f"grouped backward {proj} {name}: {r} > {BWD_TOL}")
            worst = max(worst, (a, r))
        wg_worst = max(wg_worst, errs["dw kernel"])
        # dx reads the stacks as they lie: no copy of them
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dx()
        torch.cuda.synchronize()
        dx_peak = torch.cuda.max_memory_allocated() - base
        if dx_peak >= w.numel() * w.element_size() // 4:
            raise AssertionError(f"grouped backward {proj}: dx allocated {dx_peak} bytes, "
                                 f"a copy of the stacks")
        xg, wg_ = x.clone().requires_grad_(), w.clone().requires_grad_()

        def plain_fwd_bwd():
            return torch.autograd.grad(mm.moe_grouped_matmul_plain(xg, wg_, gsz), (xg, wg_), dy)

        def fn_fwd_bwd():
            return torch.autograd.grad(mm.moe_grouped_matmul(xg, wg_, gsz), (xg, wg_), dy)

        every = {name: sorted(launched_kernels(call) | launched_kernels(call))
                 for name, call in (("forward", fwd), ("dx", dx), ("dw", dw))}
        r = {"rows": m, "k": k, "n": n, "groups": gsz.tolist(),
             "errors": {name: {"abs": a, "rel": rr} for name, (a, rr) in errs.items()},
             "forward_kernels": kernels_of_retraced(fwd), "dx_kernels": kernels_of_retraced(dx),
             "dw_kernels": kernels_of_retraced(dw), "launched": every,
             "dx_peak_bytes": dx_peak,
             "forward_ms": median_ms(fwd, **fast),
             "forward_graph_ms": graph_ms_or_none(f"{proj} forward", fwd, reps=2),
             "dx_graph_ms": graph_ms_or_none(f"{proj} dx", dx, reps=2),
             "dw_ms": median_ms(dw, **fast),
             "dw_graph_ms": graph_ms_or_none(f"{proj} dw", dw, reps=2),
             "backward_graph_ms": graph_ms_or_none(f"{proj} backward", bwd, reps=2),
             "fwd_bwd_ms": median_ms(fn_fwd_bwd, **fast),
             "plain_forward_ms": median_ms(lambda: mm.moe_grouped_matmul_plain(x, w, gsz),
                                           **fast),
             "plain_dw_ms": median_ms(lambda: mm.grouped_weight_grad_plain(x, dy, gsz, e),
                                      **fast),
             "plain_fwd_bwd_ms": median_ms(plain_fwd_bwd, **fast),
             # forward (and dx): rows, f32 stacks and bf16 outputs once; bf16
             # MMAs
             **{f"forward_{key}": v for key, v in bound(
                 nbytes(x, w) + m * n * 2, 2 * m * k * n, "bf16").items()},
             # dw: rows and gradients read, the f32 dw written; the routed
             # products on bf16 MMAs
             **{f"dw_{key}": v for key, v in bound(
                 nbytes(x, dy) + w.numel() * 4, 2 * m * k * n, "bf16").items()},
             # backward: what the function needs, w, x and dy read, dx and
             # dw (f32) written; dx's and dw's routed products, bf16 MMAs
             # with f32 sums
             **{f"backward_{key}": v for key, v in bound(
                 nbytes(w, x, dy) + m * k * 2 + w.numel() * 4,
                 2 * 2 * m * k * n, "bf16").items()}}
        wb = w.to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
        wbt = w.transpose(1, 2).to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
        r["grouped_mm_bf16_forward_ms"] = grouped_mm_time(x, wb, offs)
        r["grouped_mm_bf16_dx_ms"] = grouped_mm_time(dy, wbt, offs)
        del wb, wbt
        r["cast_graph_ms"] = graph_ms_or_none("cast", lambda: w.to(torch.bfloat16), reps=2)
        r["cast_grouped_mm_graph_ms"] = cast_grouped_mm_graph_ms(x, w, offs)
        r["grouped_mm_wgrad_bf16_ms"] = grouped_mm_time(x.t(), dy, offs)
        log(f"  grouped backward {proj}: " + json.dumps(
            {key: v for key, v in r.items() if key not in ("groups", "errors", "launched")}))
        log(f"  grouped backward {proj} kernels launched: {json.dumps(every)}")
        shapes[proj] = r
        del x, w, dy, wt, xg, wg_
        free_card()
    # #11's grouped-rows kernel over f32 stacks: the dedup route (a float
    # MoE decoder's batched decode) still reaches it, at 16 rows
    w = torch.randn(e, h, f, generator=gen, device="cuda") * 0.02
    xs16 = (torch.randn(16, h, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    g16 = torch.tensor([3, 2, 0, 4, 1, 2, 3, 1], device="cuda")

    def rows_f32():
        return mm.grouped_rows(xs16, w, None, g16)
    a, rr = rel_err(rows_f32(), mm.moe_grouped_matmul_plain(xs16, w, g16))
    before = kernels.variant_counts().get("moe_grouped w=f32", 0)
    rows_f32()
    counted = kernels.variant_counts().get("moe_grouped w=f32", 0) - before
    found = kernels_of_retraced(rows_f32)
    shapes["grouped_rows_f32"] = {"rows": 16, "k": h, "n": f, "max_abs_err": a,
                                  "max_rel_err": rr, "kernels": found,
                                  "launches_a_call": counted,
                                  "graph_ms": graph_ms_or_none("grouped rows f32", rows_f32,
                                                               reps=2)}
    log(f"  grouped rows over f32 stacks: {json.dumps(shapes['grouped_rows_f32'])}"
        + ("" if found else "; the traces named no rk_ kernel, the count stands"))
    if (rr > BWD_TOL or counted != 1
            or found and "rk_moe_grouped_mma_kernel" not in found):
        raise AssertionError(f"grouped rows over f32 stacks: {shapes['grouped_rows_f32']}")
    worst = max(worst, (a, rr))
    del w, xs16
    free_card()
    up = shapes["up"]
    return {"max_abs_err": worst[0], "max_rel_err": worst[1], "tolerance_rel": BWD_TOL,
            "ms": up["forward_ms"], "graph_ms": up["forward_graph_ms"],
            "plain_ms": up["plain_forward_ms"], "bound_ms": up["forward_bound_ms"],
            "bound_by": up["forward_bound_by"], "library_ms": None,
            "library_none": "torch._grouped_mm takes bf16 operands: no library call "
                            "computes the product over f32 stacks (its bf16-stack time "
                            "and the cast plus it are in shapes)", "shapes": shapes,
            "wgrad": {"max_abs_err": wg_worst[0], "max_rel_err": wg_worst[1],
                      "tolerance_rel": BWD_TOL, "ms": up["dw_ms"],
                      "graph_ms": up["dw_graph_ms"], "plain_ms": up["plain_dw_ms"],
                      "bound_ms": up["dw_bound_ms"], "bound_by": up["dw_bound_by"],
                      "library_ms": None,
                      "library_none": "torch._grouped_mm's wgrad writes bf16, not f32 (its "
                                      "time is in the stack row's shapes)",
                      "shapes": {proj: {key: shapes[proj][key] for key in (
                          "rows", "k", "n", "dw_kernels", "dw_ms", "dw_graph_ms",
                          "plain_dw_ms", "dw_bound_ms", "dw_bound_by",
                          "grouped_mm_wgrad_bf16_ms")} for proj in ("up", "down")}}}


def cast_grouped_mm_graph_ms(x, w, offs):
    """The library route over f32 stacks, in a graph: one copy casts the
    stacks to bf16 in the (n, k) layout torch._grouped_mm takes, then that
    call (a yardstick), or None (logged) where the card's torch lacks it."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None
    e, k, n = w.shape
    wb = torch.empty((e, n, k), dtype=torch.bfloat16, device=w.device)

    def call():
        wb.copy_(w.transpose(1, 2))
        return torch._grouped_mm(x, wb.transpose(1, 2), offs=offs)
    return graph_ms_or_none("cast + _grouped_mm", call, reps=2)


def grouped_mm_time(xs, w, offs):
    """torch._grouped_mm on bf16 stacks (a yardstick), or None where the
    card's torch lacks or refuses it (logged)."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None
    try:
        return median_ms(lambda: torch._grouped_mm(xs, w, offs=offs), reps=2, rounds=3,
                         warm_rounds=3)
    except Exception as exc:  # the yardstick is optional; its refusal is logged
        log(f"  torch._grouped_mm refused: {str(exc).splitlines()[0][:120]}")
        return None


def run_train_moe(seed: int) -> dict:
    """Phase 9 (2): Mixtral-8x7B's shape at full width and one layer, f32
    weights computed in bf16, moe_grouped="on": TRAIN_STEPS AdamW steps
    ("train moe": each expert projection's forward and dx through #12's
    stack kernel over the f32 stacks, counted as moe_grouped_stack w=f32
    and dx w=f32, and its dw through moe_grouped_wgrad); the aux loss at
    least 1 - 1e-5, the router moved."""
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.models.decoder import LlamaConfig
    from ragmeup_tpu_torch.train.train import make_decoder_train_step
    cfg = LlamaConfig.mixtral_8x7b(num_layers=1, quantization="none", moe_grouped="on")
    batch = train_batch(torch.Generator(device="cuda").manual_seed(seed + 43), cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step = make_decoder_train_step(cfg, learning_rate=TRAIN_LR, seed=seed + 42,
                                          device="cuda")
    n_params = sum(t.numel() for t in state.params.values())
    log(f"train moe: {n_params / 1e9:.3f} B f32 parameters built in "
        f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_B} x {TRAIN_S}")
    router0 = state.params["layers.0.mlp.router"].detach().clone()
    kernels.reset_counts()
    state, steps = train_steps("train moe", state, step, batch, TRAIN_STEPS)
    counts, variants = kernels.launch_counts(), kernels.variant_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = (state.params["layers.0.mlp.router"] - router0).abs().max().item()
    log(f"train moe: peak {peak:.2f} GiB allocated; the router moved by {moved:.3e}")
    if min(r["aux_loss"] for r in steps) < 1.0 - 1e-5 or not moved > 0:
        raise AssertionError(f"train moe: aux {[r['aux_loss'] for r in steps]}, "
                             f"router moved {moved}")
    # each step: gate, up and down, forward and dx each at least one launch,
    # dw one
    if (counts["moe_grouped_stack"] < 6 * TRAIN_STEPS
            or counts["moe_grouped_wgrad"] != 3 * TRAIN_STEPS):
        raise AssertionError(f"train moe: {counts['moe_grouped_stack']} grouped launches, "
                             f"{counts['moe_grouped_wgrad']} dw launches")
    del state, step, router0
    free_card()
    return {"train moe": train_run("train moe", steps, counts, variants,
                                   params_b=round(n_params / 1e9, 4), peak_gib=round(peak, 2),
                                   router_moved=moved)}


def run_training(seed: int, root: str) -> dict:
    """Phase 9: the 8B train steps and their checkpoint round trip and
    serving, the Mixtral train steps, and the grouped backward's check."""
    import torch
    t0 = time.perf_counter()
    runs = run_train_8b(seed, root)
    runs.update(run_train_moe(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 44)
    runs["train moe"]["grouped_backward"] = check_grouped_backward(gen)
    free_card()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return runs


def launches(name: str, runs: dict) -> int:
    """A kernel's launches over the runs of requests; for an instantiation
    row ("paged_attention hd=96", "flash_gqa g=7") those of the kernel at
    that head dim or group."""
    kernel, _, sel = name.partition(" ")
    if not sel:
        return sum(run["counts"][name] for run in runs.values())
    return sum(n for run in runs.values() for key, n in run.get("variants", {}).items()
               if key.split(" ")[0] == kernel and sel in key.split(" ")[1:])


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
    mark("the build")

    clock_before = clocks()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {  # N_DOCS rows fill the dense index's capacity exactly
        "topk": (stamped(check_topk(gen)), "ragmeup_tpu_torch/csrc/topk.cu",
                 "ragmeup_tpu/ops/topk.py:63"),
        "int8_matmul": (stamped(check_int8_matmul(gen)),
                        "ragmeup_tpu_torch/csrc/quant_matmul.cu",
                        "ragmeup_tpu/ops/quant_matmul.py:27"),
        "flash_gqa": (stamped(check_flash(gen)),
                      "ragmeup_tpu_torch/csrc/flash_attention.cu",
                      "ragmeup_tpu/ops/attention.py:156"),
        "topk_int8": (stamped(check_topk_int8(gen)),
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
    # the instantiations the checkpoint families add: rows "kernel hd=..." /
    # "kernel g=7", launches counted by head dim and group
    for row, r in check_flash_families(gen).items():
        results[f"flash_gqa {row}"] = (stamped(r), "ragmeup_tpu_torch/csrc/flash_attention.cu",
                                       "ragmeup_tpu/ops/attention.py:156")
    free_card()
    for name, r in check_paged_families(gen).items():
        results[name] = (stamped(r), "ragmeup_tpu_torch/csrc/paged_attention.cu",
                         "ragmeup_tpu/ops/paged_attention.py:487")
    free_card()
    results["moe_gather"] = (stamped(check_moe_gather(gen)),
                             "ragmeup_tpu_torch/csrc/moe_matmul.cu",
                             "ragmeup_tpu/ops/moe_matmul.py:47")
    free_card()
    grouped = {name: stamped(r) for name, r in check_moe_grouped(gen).items()}
    for name, src, rep in (("moe_grouped", "moe_matmul.cu", 123),
                           ("moe_grouped w=bf16", "moe_matmul.cu", 123),
                           ("moe_grouped_stack", "moe_stack.cu", 220)):
        results[name] = (grouped[name], f"ragmeup_tpu_torch/csrc/{src}",
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
    mark("phase 3")

    runs = run_system(args.seed)
    # phase 9's rows: the grouped GEMM over a train step's f32 stacks (#12's
    # stack kernel, forward and dx), and its dw kernel, launched by "train moe"
    grouped_bwd = runs["train moe"].pop("grouped_backward")
    results["moe_grouped_wgrad"] = (grouped_bwd.pop("wgrad"),
                                    "ragmeup_tpu_torch/csrc/moe_wgrad.cu",
                                    "none: ragmeup_tpu/ops/moe_matmul.py:430 computes dw "
                                    "in XLA")
    results["moe_grouped_stack w=f32"] = (grouped_bwd, "ragmeup_tpu_torch/csrc/moe_stack.cu",
                                          "ragmeup_tpu/ops/moe_matmul.py:220")
    for label, run in runs.items():
        log(f"{label}: {run.get('latency_of', '/chat latency per request (s)')}: "
            f"{[round(x, 3) for x in run['latency_s']]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches(name, runs),
         **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         **{key: r.get(key) for key in ("graph_ms", "library_graph_ms", "kernel_ms",
                                        "kernel_graph_ms", "shapes")}}
        for name, (r, src, rep) in results.items()],
        "clocks_sm_mem": {"before_kernel_checks": clock_before,
                          "after_kernel_checks": clock_after},
        "checkpoints": CHECKPOINTS,
        "tokenizers": TOKENIZERS,
        "retrieval_at_scale": runs["corpus sharded"]["readings"],
        "model_axis": runs["tp4"]["readings"],
        "training": {label: runs[label]["readings"] for label in ("train 8b", "train moe")}}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
