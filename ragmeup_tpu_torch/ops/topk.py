"""Fused dense scoring + top-k: the CUDA kernel and its plain version.

Counterpart of ``ragmeup_tpu/ops/topk.py``. ``dense_topk`` scores
``queries (b, d) @ corpus_t (d, N) + mask`` and returns the k best
``(score, index)`` pairs per query, ties to the lowest index, without
writing the (b, N) score matrix to device memory (csrc/topk.cu). Queries
are cast to the corpus dtype before the dot, as the TPU kernel does, so
near-tie ids agree with it.

Slots that no live column fills (k larger than the live rows) come out as
``(NEG_INF, -1)``: dead and padding columns carry the additive mask value
NEG_INF and never outrank an unfilled slot, exactly as in the TPU merge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch import kernels

NEG_INF = float(-1e30)
MAX_K = 128
_CHUNK = 1024  # columns per block in csrc/topk.cu


def rank_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered by (-score, index).

    ``torch.topk`` does not promise the lowest index among equal scores; a
    stable descending sort does."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def dense_topk_plain(queries: torch.Tensor, corpus_t: torch.Tensor, k: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (materializes the scores)."""
    q = queries.to(corpus_t.dtype).float()
    s = q @ corpus_t.float()
    if mask is not None:
        s = s + mask.reshape(1, -1).float()
    s, i = rank_topk(s, k)
    unfilled = s <= NEG_INF
    s = torch.where(unfilled, torch.full_like(s, NEG_INF), s)
    i = torch.where(unfilled, torch.full_like(i, -1), i)
    return s, i.to(torch.int32)


def _dense_topk_cuda(queries, corpus_t, k, mask):
    d, n = corpus_t.shape
    b = queries.shape[0]
    if corpus_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense_topk kernel: corpus dtype {corpus_t.dtype}")
    if d > 1024:
        raise ValueError(f"dense_topk kernel: d={d} > 1024")
    q = queries.to(corpus_t.dtype).contiguous()
    mask = mask.reshape(-1).float().contiguous()
    if mask.numel() != n:
        raise ValueError(f"mask has {mask.numel()} columns, corpus {n}")
    kernels.require_cuda("dense_topk", q, corpus_t, mask)
    nchunks = -(-n // _CHUNK)
    ws_s = torch.empty(2 * b * nchunks * k, dtype=torch.float32, device=q.device)
    ws_i = torch.empty(2 * b * nchunks * k, dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    lib = kernels.lib()
    err = lib.rk_topk(q.data_ptr(), corpus_t.data_ptr(), mask.data_ptr(), b, d,
                      n, k, kernels.dtype_code(corpus_t.dtype), ws_s.data_ptr(),
                      ws_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                      kernels.stream_handle(q.device))
    kernels.check(err, "dense_topk")
    kernels.count("topk")
    return out_s, out_i


def dense_topk(queries: torch.Tensor, corpus_t: torch.Tensor, k: int,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scores = queries @ corpus_t + mask → top-k (scores f32 (b, k),
    indices i32 (b, k)), ties to the lowest index.

    queries (b, d); corpus_t (d, N) with N a multiple of the kernel's
    1024-column chunk; mask (1, N) additive f32 (0 live / NEG_INF dead and
    padding). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K} for the fused top-k")
    d, n = corpus_t.shape
    if n % _CHUNK:
        raise ValueError(f"corpus columns ({n}) must be a multiple of {_CHUNK}")
    if k > n:
        raise ValueError(f"k={k} larger than the corpus ({n})")
    if mask is None:
        mask = torch.zeros((1, n), dtype=torch.float32, device=corpus_t.device)
    if corpus_t.is_cuda:
        return _dense_topk_cuda(queries, corpus_t, k, mask)
    return dense_topk_plain(queries, corpus_t, k, mask)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization along ``axis``."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def topk_oracle(queries: np.ndarray, corpus: np.ndarray, k: int,
                dead_rows=()) -> Tuple[np.ndarray, np.ndarray]:
    """Exact NumPy oracle: scores = q @ corpus.T, top-k sorted by
    (-score, index). corpus is (n, d) row-major (NOT transposed)."""
    s = queries.astype(np.float64) @ corpus.astype(np.float64).T
    if len(dead_rows):
        s[:, list(dead_rows)] = -np.inf
    b, n = s.shape
    out_s = np.zeros((b, k), np.float64)
    out_i = np.zeros((b, k), np.int64)
    for r in range(b):
        order = np.lexsort((np.arange(n), -s[r]))[:k]
        out_s[r] = s[r][order]
        out_i[r] = order
    return out_s, out_i
