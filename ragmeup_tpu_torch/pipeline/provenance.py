"""Provenance attribution: how much did each retrieved document contribute
to the answer?

All four reference methods (``server/provenance.py``, README provenance
docs), re-designed for the device engines:

- **rerank** (``provenance.py:100-108``): re-score docs with the cross-
  encoder against query+answer — free reuse of the on-device rerank path.
- **attention** (``provenance.py:19-88``): forward the full thread through
  the local decoder capturing attention, then average last-layer attention
  mass between the answer span and each document span (optionally including
  the query span). The reference materializes the full attention matrix via
  HF ``output_attentions``; here capture is a flag on the same jit'd
  forward.
- **similarity** (``provenance.py:164-201``): sentence-encoder embeddings,
  cosine of each doc with answer (and query), normalized to sum 1.
- **llm** (``provenance.py:110-162``): prompt the LLM for a 0-5 score per
  doc, regex-extract the last number. Scores are returned as floats (the
  reference returned strings — quirk not reproduced, SURVEY.md §5.6).

The port's copy of ``ragmeup_tpu/pipeline/provenance.py``. Threads longer
than ``blockwise_threshold`` take the blockwise branch: the last layer's
(q, k) from ``qk_forward`` and ``ops.attention.span_attention_mass`` per
head, so the L×L matrix is never built.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ragmeup_tpu_torch.data.documents import Chunk
from ragmeup_tpu_torch.ops.attention import span_attention_mass


def compute_rerank_provenance(cross_encoder, query: str, answer: str,
                              chunks: List[Chunk],
                              include_query: bool = True) -> List[float]:
    probe = (query + "\n" + answer) if include_query else answer
    scores = cross_encoder.score([(probe, c.content) for c in chunks])
    return [float(s) for s in scores]


def compute_similarity_provenance(encoder, query: str, answer: str,
                                  chunks: List[Chunk],
                                  include_query: bool = False) -> List[float]:
    texts = [answer, query] + [c.content for c in chunks]
    embs = np.asarray(encoder.encode(texts), np.float64)
    ans, qry, docs = embs[0], embs[1], embs[2:]
    sim_ans = docs @ ans
    if include_query:
        sims = (sim_ans + docs @ qry) / 2.0
    else:
        sims = sim_ans
    total = sims.sum()
    if total > 0:
        sims = sims / total
    return [float(s) for s in sims]


_LAST_NUM_RE = re.compile(r"(\d+(?:\.\d+)?)")


def compute_llm_provenance(chat_fn: Callable[[str], str], prompt_template: str,
                           query: str, answer: str,
                           chunks: List[Chunk]) -> List[float]:
    """chat_fn: single-prompt → completion string (local or cloud backend)."""
    out: List[float] = []
    for c in chunks:
        prompt = (prompt_template
                  .replace("{query}", query)
                  .replace("{answer}", answer)
                  .replace("{context}", c.content))
        reply = chat_fn(prompt)
        nums = _LAST_NUM_RE.findall(reply or "")
        out.append(float(nums[-1]) if nums else 0.0)
    return out


def _find_span(hay: Sequence[int], needle: Sequence[int]) -> Optional[tuple]:
    """First occurrence of token sublist (reference provenance.py:90-98)."""
    n, m = len(hay), len(needle)
    if m == 0 or m > n:
        return None
    for i in range(n - m + 1):
        if list(hay[i:i + m]) == list(needle):
            return (i, i + m)
    return None


def compute_attention_provenance(llm, query: str, answer: str,
                                 chunks: List[Chunk],
                                 include_query: bool = False,
                                 blockwise: Optional[bool] = None,
                                 blockwise_threshold: int = 2048
                                 ) -> List[float]:
    """Mean last-layer attention between the answer (and optionally query)
    span and each document span, normalized across documents.

    The thread is tokenized as one sequence: docs, query, answer — matching
    the reference's structure of the full conversation forward
    (provenance.py:28-67). Spans are located by token-sublist search.
    """
    tok = llm.tokenizer
    doc_ids = [tok.tokenize_ids(c.content) for c in chunks]
    query_ids = tok.tokenize_ids(query)
    answer_ids = tok.tokenize_ids(answer)
    sep = [tok.sep_id] if hasattr(tok, "sep_id") else []
    ids: List[int] = []
    for d in doc_ids:
        ids.extend(d + sep)
    ids.extend(query_ids + sep)
    ids.extend(answer_ids)
    max_len = llm.cfg.max_seq_len
    ids = ids[:max_len]

    spans = []
    pos = 0
    for d in doc_ids:
        spans.append((pos, min(pos + len(d), len(ids))))
        pos += len(d) + len(sep)
    q_span = (pos, min(pos + len(query_ids), len(ids)))
    pos += len(query_ids) + len(sep)
    a_span = (pos, min(pos + len(answer_ids), len(ids)))

    if blockwise is None:
        blockwise = len(ids) > blockwise_threshold
    if blockwise and a_span[1] > a_span[0]:
        # long-context path: blockwise span mass over last-layer (q, k)
        q_all, k_all = llm.qk_forward(ids)  # (1, L, heads, hd)
        q_all, k_all = (torch.from_numpy(t[0]).to(llm.device) for t in (q_all, k_all))
        all_spans = [s for s in spans if s[1] > s[0]]
        masses = np.zeros(len(all_spans))
        for h in range(q_all.shape[1]):
            masses += span_attention_mass(q_all[a_span[0]:a_span[1], h],
                                          k_all[:, h], all_spans, q_offset=a_span[0])
            if include_query and q_span[1] > q_span[0]:
                masses += span_attention_mass(q_all[q_span[0]:q_span[1], h],
                                              k_all[:, h], all_spans,
                                              q_offset=q_span[0])
        live = iter(masses)
        raw = [float(next(live)) if s[1] > s[0] else 0.0 for s in spans]
        total = sum(raw)
        return [r / total for r in raw] if total > 0 else raw

    weights = llm.attention_forward(ids)
    last = weights[-1][0]  # (heads, L, L)
    att = last.mean(axis=0)  # (L, L) mean over heads

    def mass(src, dst) -> float:
        s0, s1 = src
        d0, d1 = dst
        s0, s1 = min(s0, att.shape[0]), min(s1, att.shape[0])
        d0, d1 = min(d0, att.shape[1]), min(d1, att.shape[1])
        if s1 <= s0 or d1 <= d0:
            return 0.0
        return float(att[s0:s1, d0:d1].mean())

    raw = []
    for sp in spans:
        # attention is causal: answer tokens attend doc tokens
        score = mass(a_span, sp)
        if include_query:
            score = (score + mass(q_span, sp)) / 2.0
        raw.append(score)
    total = sum(raw)
    if total > 0:
        raw = [r / total for r in raw]
    return raw


def attach_provenance(chunks: List[Chunk], scores: Sequence[float]) -> List[Chunk]:
    """Write scores into metadata['provenance'] (contract from
    RAGHelper_local.py:273-308)."""
    out = []
    for c, s in zip(chunks, scores):
        md = dict(c.metadata)
        md["provenance"] = float(s)
        out.append(Chunk(content=c.content, metadata=md, id=c.id))
    return out
