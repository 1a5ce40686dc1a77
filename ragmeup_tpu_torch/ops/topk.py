"""Fused dense scoring + top-k: the CUDA kernels and their plain versions.

Counterpart of ``ragmeup_tpu/ops/topk.py``. ``dense_topk`` scores
``queries (b, d) @ corpus_t (d, N) + mask`` and returns the k best
``(score, index)`` pairs per query, ties to the lowest index, without
writing the (b, N) score matrix to device memory (csrc/topk.cu). Queries
are cast to the corpus dtype before the dot, as the TPU kernel does, so
near-tie ids agree with it. ``dense_topk_int8`` does the same over an int8
corpus with per-column scales: queries are quantized per row on the device
and scored ``float(int32 dot) * q_scale * c_scale + mask``.

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


def _rank_scores(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of materialized scores, unfilled slots as (NEG_INF, -1)."""
    s, i = rank_topk(s, k)
    unfilled = s <= NEG_INF
    s = torch.where(unfilled, torch.full_like(s, NEG_INF), s)
    i = torch.where(unfilled, torch.full_like(i, -1), i)
    return s, i.to(torch.int32)


def dense_topk_plain(queries: torch.Tensor, corpus_t: torch.Tensor, k: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (materializes the scores)."""
    q = queries.to(corpus_t.dtype).float()
    s = q @ corpus_t.float()
    if mask is not None:
        s = s + mask.reshape(1, -1).float()
    return _rank_scores(s, k)


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


def _check_topk_args(corpus_t: torch.Tensor, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K} for the fused top-k")
    n = corpus_t.shape[1]
    if n % _CHUNK:
        raise ValueError(f"corpus columns ({n}) must be a multiple of {_CHUNK}")
    if k > n:
        raise ValueError(f"k={k} larger than the corpus ({n})")


def dense_topk(queries: torch.Tensor, corpus_t: torch.Tensor, k: int,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scores = queries @ corpus_t + mask → top-k (scores f32 (b, k),
    indices i32 (b, k)), ties to the lowest index.

    queries (b, d); corpus_t (d, N) with N a multiple of the kernel's
    1024-column chunk; mask (1, N) additive f32 (0 live / NEG_INF dead and
    padding). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _check_topk_args(corpus_t, k)
    if mask is None:
        mask = torch.zeros((1, corpus_t.shape[1]), dtype=torch.float32,
                           device=corpus_t.device)
    if corpus_t.is_cuda:
        return _dense_topk_cuda(queries, corpus_t, k, mask)
    return dense_topk_plain(queries, corpus_t, k, mask)


def divide_exactly(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded on every device. PyTorch's CUDA division by
    a Python scalar multiplies by the scalar's reciprocal, which can land
    one ulp away from the division that the JAX and numpy quantizers (and
    the CUDA kernels) do; a divisor tensor on x's device keeps the true
    division."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization along ``axis``."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = divide_exactly(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dense_topk_int8_plain(queries: torch.Tensor, corpus_i8: torch.Tensor,
                          c_scale: torch.Tensor, k: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 kernel. The f32 product of int8
    values is exact (|sum| <= d * 127^2 < 2^24 for d <= 1024), so the scores
    equal the kernel's int32 sum scaled in the same order."""
    q_i8, q_scale = quantize_int8(queries.float(), axis=1)
    s = q_i8.float() @ corpus_i8.float()
    s = s * q_scale * c_scale.reshape(1, -1).float()
    if mask is not None:
        s = s + mask.reshape(1, -1).float()
    return _rank_scores(s, k)


def _dense_topk_int8_cuda(queries, corpus_i8, c_scale, k, mask):
    d, n = corpus_i8.shape
    b = queries.shape[0]
    if corpus_i8.dtype != torch.int8 or d > 1024:
        raise ValueError(f"dense_topk_int8 kernel: corpus int8 with d <= 1024 "
                         f"(got {corpus_i8.dtype}, d={d})")
    q_i8, q_scale = quantize_int8(queries.float(), axis=1)
    q_i8 = q_i8.contiguous()
    q_scale = q_scale.reshape(-1).contiguous()
    c_scale = c_scale.reshape(-1).float().contiguous()
    mask = mask.reshape(-1).float().contiguous()
    if mask.numel() != n or c_scale.numel() != n:
        raise ValueError(f"mask ({mask.numel()}) and scales ({c_scale.numel()}) "
                         f"must have the corpus's {n} columns")
    kernels.require_cuda("dense_topk_int8", q_i8, q_scale, corpus_i8, c_scale, mask)
    nchunks = n // _CHUNK
    ws_s = torch.empty(2 * b * nchunks * k, dtype=torch.float32, device=q_i8.device)
    ws_i = torch.empty(2 * b * nchunks * k, dtype=torch.int32, device=q_i8.device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=q_i8.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q_i8.device)
    err = kernels.lib().rk_topk_int8(
        q_i8.data_ptr(), q_scale.data_ptr(), corpus_i8.data_ptr(),
        c_scale.data_ptr(), mask.data_ptr(), b, d, n, k, ws_s.data_ptr(),
        ws_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        kernels.stream_handle(q_i8.device))
    kernels.check(err, "dense_topk_int8")
    kernels.count("topk_int8")
    return out_s, out_i


def dense_topk_int8(queries: torch.Tensor, corpus_i8: torch.Tensor,
                    c_scale: torch.Tensor, k: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 fused top-k: corpus_i8 (d, N) int8 with per-column dequant
    scales c_scale (1, N) f32. Queries (b, d) float are quantized per row
    on their device (``quantize_int8``); scores are
    ``float(q_i8 @ corpus_i8) * q_scale * c_scale + mask``. Same contract as
    ``dense_topk`` otherwise. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    _check_topk_args(corpus_i8, k)
    if mask is None:
        mask = torch.zeros((1, corpus_i8.shape[1]), dtype=torch.float32,
                           device=corpus_i8.device)
    if corpus_i8.is_cuda:
        return _dense_topk_int8_cuda(queries, corpus_i8, c_scale, k, mask)
    return dense_topk_int8_plain(queries, corpus_i8, c_scale, k, mask)


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
