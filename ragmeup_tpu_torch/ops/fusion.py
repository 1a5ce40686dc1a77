"""Rank fusion and diversity selection.

Counterpart of ``ragmeup_tpu/ops/fusion.py``. ``rrf_fuse`` and
``mmr_select`` are the host versions over small candidate lists (copied,
because the JAX package's ``ops`` cannot be imported without jax);
``rrf_fuse_device`` and ``mmr_select_device`` run the same selection on
tensors, with the same tie rules: RRF ranks by (score, first appearance),
MMR's argmax takes the lowest index.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def rrf_fuse(ranked_lists: Sequence[Sequence], weights: Sequence[float],
             c: int = 60, k: int = 10) -> List[Tuple[object, float]]:
    """Weighted Reciprocal Rank Fusion.

    ranked_lists: per-retriever lists of doc ids, best first.
    Returns up to k (id, fused_score) pairs, fused desc; ties broken by the
    order ids first appeared (stable)."""
    if len(ranked_lists) != len(weights):
        raise ValueError("one weight per ranked list required")
    scores: Dict[object, float] = {}
    first_seen: Dict[object, int] = {}
    seq = 0
    for lst, w in zip(ranked_lists, weights):
        for rank, doc_id in enumerate(lst):
            scores[doc_id] = scores.get(doc_id, 0.0) + w / (rank + 1 + c)
            if doc_id not in first_seen:
                first_seen[doc_id] = seq
                seq += 1
    order = sorted(scores.items(), key=lambda kv: (-kv[1], first_seen[kv[0]]))
    return order[:k]


def mmr_select(query_vec: np.ndarray, cand_vecs: np.ndarray, k: int,
               lambda_mult: float = 0.5) -> List[int]:
    """Maximal Marginal Relevance over a candidate set.

    query_vec (d,), cand_vecs (m, d); returns indices into cand_vecs of the
    k selected candidates, in selection order. Vectors need not be
    normalized (cosine is computed here)."""
    q = np.asarray(query_vec, np.float64)
    c = np.asarray(cand_vecs, np.float64)
    m = c.shape[0]
    if m == 0 or k <= 0:
        return []
    qn = q / max(np.linalg.norm(q), 1e-12)
    cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
    rel = cn @ qn  # (m,)
    sim = cn @ cn.T  # (m, m)
    selected: List[int] = [int(np.argmax(rel))]
    while len(selected) < min(k, m):
        remaining = [i for i in range(m) if i not in selected]
        max_sim_sel = sim[np.ix_(remaining, selected)].max(axis=1)
        mmr = lambda_mult * rel[remaining] - (1.0 - lambda_mult) * max_sim_sel
        selected.append(remaining[int(np.argmax(mmr))])
    return selected


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Per-row permutation ordering by (primary, secondary), both ascending."""
    o1 = torch.sort(secondary, dim=1, stable=True).indices
    p = torch.gather(primary, 1, o1)
    o2 = torch.sort(p, dim=1, stable=True).indices
    return torch.gather(o1, 1, o2)


def rrf_fuse_device(ids_a: torch.Tensor, ids_b: torch.Tensor, w_a: float,
                    w_b: float, c: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted RRF of two ranked id lists on tensors.

    ids_a/ids_b: (b, ka/kb) int ranked ids, -1 = empty slot. Returns
    (fused_scores (b, k) f32, fused_ids (b, k) i32), ids -1-padded.
    Tie-break: higher score first, then earlier first appearance in
    [a | b] order (the host rrf_fuse semantics)."""
    b, ka = ids_a.shape
    kb = ids_b.shape[1]
    dev = ids_a.device
    ranks_a = torch.arange(ka, dtype=torch.float32, device=dev)
    ranks_b = torch.arange(kb, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sc_a = torch.where(ids_a >= 0, w_a / (ranks_a[None, :] + 1 + c), zero)
    sc_b = torch.where(ids_b >= 0, w_b / (ranks_b[None, :] + 1 + c), zero)
    ids = torch.cat([ids_a, ids_b], dim=1).to(torch.int32)
    scores = torch.cat([sc_a, sc_b], dim=1)
    pos = torch.arange(ka + kb, dtype=torch.int32, device=dev).expand(b, -1)
    # sort by id so duplicates are adjacent (-1 padding sorts first); one id
    # appears at most once per list, so a run of equal live ids has length 2
    order = torch.sort(ids, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    sc_s = torch.gather(scores, 1, order)
    pos_s = torch.gather(pos, 1, order)
    eq = ids_s[:, 1:] == ids_s[:, :-1]
    no = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    same_prev = torch.cat([no, eq], dim=1)
    nxt_same = torch.cat([eq, no], dim=1)
    sc_merged = torch.where(nxt_same, sc_s + torch.roll(sc_s, -1, dims=1), sc_s)
    pos_merged = torch.where(nxt_same,
                             torch.minimum(pos_s, torch.roll(pos_s, -1, dims=1)),
                             pos_s)
    alive = (~same_prev) & (ids_s >= 0)
    sc_final = torch.where(alive, sc_merged, torch.full_like(sc_merged, -1.0))
    pos_final = torch.where(alive, pos_merged, torch.full_like(pos_merged, 2**30))
    rank = _lexsort2(-sc_final, pos_final)[:, :k]
    sc_sorted = torch.gather(sc_final, 1, rank)
    ids_sorted = torch.gather(ids_s, 1, rank)
    valid = sc_sorted > 0
    return (torch.where(valid, sc_sorted, torch.zeros_like(sc_sorted)),
            torch.where(valid, ids_sorted, torch.full_like(ids_sorted, -1)))


def mmr_select_device(qn: torch.Tensor, cand: torch.Tensor,
                      valid: torch.Tensor, k: int, lambda_mult: float
                      ) -> torch.Tensor:
    """Maximal Marginal Relevance selection on tensors (one query).

    Same selection order as ``mmr_select``, including argmax ties to the
    lowest index. qn: (d,) normalized query; cand: (m, d) candidate vectors
    (normalized here); valid: (m,) bool, invalid rows never selected.
    Returns (k,) int32 indices into cand in selection order, -1-padded.
    The loop never reads a value back to the host."""
    norm = torch.sqrt((cand * cand).sum(dim=1, keepdim=True))
    cn = cand / torch.clamp_min(norm, 1e-12)
    neg = torch.tensor(-torch.inf, dtype=torch.float32, device=cand.device)
    rel = torch.where(valid, cn @ qn, neg)
    sim = cn @ cn.T
    m = cand.shape[0]
    sel_mask = torch.zeros(m, dtype=torch.bool, device=cand.device)
    max_sim = torch.full((m,), -torch.inf, dtype=torch.float32,
                         device=cand.device)
    order = torch.full((k,), -1, dtype=torch.int32, device=cand.device)
    for i in range(min(k, m)):
        # first pick is pure relevance (mmr_select seeds with argmax(rel))
        score = rel if i == 0 else \
            lambda_mult * rel - (1.0 - lambda_mult) * max_sim
        score = torch.where(sel_mask | ~valid, neg, score)
        j = torch.argmax(score)  # first maximal index
        ok = score[j] > neg
        order[i] = torch.where(ok, j.to(torch.int32), order[i])
        sel_mask[j] = sel_mask[j] | ok
        max_sim = torch.where(ok, torch.maximum(max_sim, sim[:, j]), max_sim)
    return order
