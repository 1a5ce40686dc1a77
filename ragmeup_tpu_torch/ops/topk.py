"""Fused dense scoring + top-k: the CUDA kernels and their plain versions.

Counterpart of ``ragmeup_tpu/ops/topk.py``. ``dense_topk`` scores
``queries (b, d) @ corpus_t (d, N) + mask`` and returns the k best
``(score, index)`` pairs per query, ties to the lowest index, without
writing the (b, N) score matrix to device memory (csrc/topk.cu). Queries
are cast to the corpus dtype before the dot, as the TPU kernel does, so
near-tie ids agree with it. ``dense_topk_int8`` does the same over an int8
corpus with per-column scales: queries are quantized per row
(``quantize_int8``; inside the kernel on the card) and scored
``float(int32 dot) * q_scale * c_scale + mask``.

On the card a call is one launch of the scoring kernel over the grid
``topk_plan`` gives (row groups of up to 64 queries, each over runs of
128-column tiles, sized from the SM count), each block keeping its own
top-k by threshold selection; the blocks' candidates are merged per query
row by a second launch or, for a single query, by the last block to
finish.

Slots that no live column fills (k larger than the live rows) come out as
``(NEG_INF, -1)``: dead and padding columns carry the additive mask value
NEG_INF and never outrank an unfilled slot, exactly as in the TPU merge.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch import kernels

NEG_INF = float(-1e30)
MAX_K = 128
_CHUNK = 1024  # the corpus's columns come in multiples of this (DenseIndex pads)

# csrc/topk.cu's constants
_TILE = 128                      # corpus columns a block scores at once (kTile)
_RING_BYTES = 8 * 8192           # its cp.async ring (kStages x kStageBytes)
_SMEM_BLOCK = 232448             # shared memory one block may take (227 KB)
_SMEM_SM = 233472                # an SM's, 1 KB of it reserved per block
_BLOCKS_PER_SM = 2               # the grid's target where two blocks fit
_MAX_ROWS = 64                   # query rows a block (8 n-tiles of the mma)
_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


MERGE_ROUTES = ("launch", "last_block")


class TopkPlan(NamedTuple):
    rows: int    # query rows a block: 8, 16, 32 or 64
    groups: int  # row groups, ceil(b / rows)
    blocks: int  # column blocks a row group, each a run of whole tiles
    tiles: int   # 128-column tiles of the corpus
    merge: str   # how the blocks' candidates meet, one of MERGE_ROUTES


def topk_kp(k: int) -> int:
    """Length of a block's ranked list and of its candidate buffer per
    query row: k rounded up to 32, 64 or 128 (a warp's bitonic width)."""
    return 32 if k <= 32 else (64 if k <= 64 else 128)


def topk_smem(rows: int, d: int, k: int, kind: str) -> int:
    """Shared memory of one scoring block (csrc/topk.cu score_smem): the
    ring, the staged queries (d rounded to 64 plus a 16-byte pad a row),
    the int8 row scales, a tile's scores (a row of 132 f32), and each
    row's ranked list, buffer and count."""
    d64 = -(-d // 64) * 64
    return (_RING_BYTES + rows * (d64 * _ITEMSIZE[kind] + 16) + rows * 4
            + rows * (_TILE + 4) * 4 + rows * topk_kp(k) * 16 + rows * 4)


def topk_plan(n: int, b: int, sms: int, d: int = 384, k: int = 20,
              kind: str = "bf16") -> TopkPlan:
    """Grid of the scoring kernel: row groups of the fewest n-tiles that
    hold b (at most 64 rows, fewer where the staged queries and lists
    would not fit a block's shared memory), and per group enough column
    blocks for ``_BLOCKS_PER_SM`` blocks an SM (one where only one fits),
    never more than the corpus has tiles. A single query's candidates are
    merged by the last block to finish ("last_block": no second launch);
    more rows by a second launch, a block a row ("launch"), where the last
    block would merge its group's rows one after another."""
    rows = 8
    while rows < min(b, _MAX_ROWS):
        rows *= 2
    while rows > 8 and topk_smem(rows, d, k, kind) > _SMEM_BLOCK:
        rows //= 2
    groups = -(-b // rows)
    per_sm = max(1, min(_BLOCKS_PER_SM, _SMEM_SM // (topk_smem(rows, d, k, kind) + 1024)))
    tiles = n // _TILE
    blocks = max(1, min(tiles, -(-sms * per_sm // groups)))
    return TopkPlan(rows, groups, blocks, tiles, "last_block" if b == 1 else "launch")


def topk_block_tiles(plan: TopkPlan, p: int) -> Tuple[int, int]:
    """The tiles [t0, t1) column block p scores (csrc/topk.cu)."""
    return plan.tiles * p // plan.blocks, plan.tiles * (p + 1) // plan.blocks


def rank_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered by (-score, index).

    ``torch.topk`` does not promise the lowest index among equal scores; a
    stable descending sort does."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def merge_sorted(scores: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (b, m) candidates by (-score, id) and keep k: a stable sort by
    id, then a stable sort by -score (torch has no two-key sort)."""
    ids_s, o1 = torch.sort(ids, dim=1, stable=True)
    neg, o2 = torch.sort(-torch.gather(scores, 1, o1), dim=1, stable=True)
    return -neg[:, :k], torch.gather(ids_s, 1, o2)[:, :k]


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


# (device index, stream) -> zeroed words, one a row group, that the kernel's
# last-block route takes tickets from (kernels.ticket_words)
_TICKETS: dict = {}


def _tickets(device, groups: int) -> torch.Tensor:
    return kernels.ticket_words(_TICKETS, device, groups)


def _topk_launch(entry: str, counter: str, kind: str, q, corpus_t, k, args, merge=None):
    """Plans the grid, allocates the candidates and the output, calls the
    C entry ``entry`` with ``args`` (its arguments before b) and counts one
    launch of ``counter``. ``merge`` (one of MERGE_ROUTES, by default the
    plan's; chip_smoke.py times both) says how the blocks' candidates meet:
    a second launch, or the last block of each row group to finish,
    elected by a ticket."""
    d, n = corpus_t.shape
    b = q.shape[0]
    plan = topk_plan(n, b, kernels.sm_count(q.device.index), d, k, kind)
    merge = merge or plan.merge
    cand = plan.blocks * b * k if plan.blocks > 1 else 1
    cand_s = torch.empty(cand, dtype=torch.float32, device=q.device)
    cand_i = torch.empty(cand, dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    ticket = (_tickets(q.device, plan.groups).data_ptr()
              if merge == "last_block" and plan.blocks > 1 else None)
    err = getattr(kernels.lib(), entry)(
        *args, b, d, n, k, plan.rows, plan.blocks, cand_s.data_ptr(), cand_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), ticket, kernels.stream_handle(q.device))
    kernels.check(err, entry)
    kernels.count(counter)
    return out_s, out_i


def _dense_topk_cuda(queries, corpus_t, k, mask, merge=None):
    d, n = corpus_t.shape
    if corpus_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense_topk kernel: corpus dtype {corpus_t.dtype}")
    if d > 1024:
        raise ValueError(f"dense_topk kernel: d={d} > 1024")
    q = queries.float().contiguous()  # cast to the corpus dtype in the kernel
    mask = mask.reshape(-1).float().contiguous()
    if mask.numel() != n:
        raise ValueError(f"mask has {mask.numel()} columns, corpus {n}")
    kernels.require_cuda("dense_topk", q, corpus_t, mask)
    kind = "bf16" if corpus_t.dtype == torch.bfloat16 else "f32"
    return _topk_launch("rk_topk", "topk", kind, q, corpus_t, k, (
        q.data_ptr(), corpus_t.data_ptr(), kernels.dtype_code(corpus_t.dtype),
        mask.data_ptr()), merge)


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

    queries (b, d); corpus_t (d, N) with N a multiple of 1024 (DenseIndex
    pads to it); mask (1, N) additive f32 (0 live / NEG_INF dead and
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


def _dense_topk_int8_cuda(queries, corpus_i8, c_scale, k, mask, merge=None):
    d, n = corpus_i8.shape
    if corpus_i8.dtype != torch.int8 or d > 1024:
        raise ValueError(f"dense_topk_int8 kernel: corpus int8 with d <= 1024 "
                         f"(got {corpus_i8.dtype}, d={d})")
    q = queries.float().contiguous()  # quantized per row inside the kernel
    c_scale = c_scale.reshape(-1).float().contiguous()
    mask = mask.reshape(-1).float().contiguous()
    if mask.numel() != n or c_scale.numel() != n:
        raise ValueError(f"mask ({mask.numel()}) and scales ({c_scale.numel()}) "
                         f"must have the corpus's {n} columns")
    kernels.require_cuda("dense_topk_int8", q, corpus_i8, c_scale, mask)
    return _topk_launch("rk_topk_int8", "topk_int8", "int8", q, corpus_i8, k, (
        q.data_ptr(), corpus_i8.data_ptr(), c_scale.data_ptr(), mask.data_ptr()), merge)


def dense_topk_int8(queries: torch.Tensor, corpus_i8: torch.Tensor,
                    c_scale: torch.Tensor, k: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 fused top-k: corpus_i8 (d, N) int8 with per-column dequant
    scales c_scale (1, N) f32. Queries (b, d) float are quantized per row
    (``quantize_int8``; on the card inside the kernel); scores are
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
