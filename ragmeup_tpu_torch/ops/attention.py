"""Causal flash attention (forward, grouped-query): CUDA kernel and plain version.

Counterpart of ``ragmeup_tpu/ops/attention.py``: ``flash_attention_gqa``
takes q ``(b·nkv, g, s, hd)`` (the g query heads of one kv head together)
against k/v ``(b·nkv, kv_len, hd)`` at the native kv-head count;
``flash_attention`` is its g = 1 case with q ``(bh, s, hd)``. The mask is
causal over absolute positions 0..s-1, so keys past s (the unused tail of a
KV cache, kv_len ≥ s) are hidden from every row. csrc/flash_attention.cu
keeps the score tile on chip; see its header. ``span_attention_mass`` is
the blockwise span mass of attention provenance. ``ring_attention`` is the
sequence-parallel prefill over a list of devices (plain PyTorch, as the JAX
package computes it in XLA).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch import kernels

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the ring's causal mask
KERNEL_HEAD_DIMS = (128, 256)  # the head dims csrc/flash_attention.cu is built for
MAX_GROUP = 64                 # query heads per kv head: one block's 64 rows
WGMMA_ROWS = 128               # query rows a block of the bf16 kernel at hd 256
WGMMA_KEYS = 64                # keys a tile of it
WGMMA_PART_LD = 258            # floats a row of a split q-block's partial: o, m, l
# (device index, stream) -> zeroed ticket words of the split q-blocks
_SPLIT_TICKETS: dict = {}


def wgmma_split_from(bkv: int, g: int, s: int, kv_len: int, sm_count: int) -> int:
    """The first 128-row q-block of csrc/flash_attention.cu's hd-256 kernel
    whose keys two blocks share (the causal tail's longest walks, halved);
    the number of q-blocks when none is split. A block of bq = 128 // g
    positions from q0 reaches ceil(min(q0 + bq, s, kv_len) / 64) key tiles.
    Of the q-blocks with more than half the longest's tiles, the longest
    are split as far as the blocks still fit one wave of the card (one
    block an SM): a second wave of pieces costs more than the walk it
    halves."""
    bq = WGMMA_ROWS // g
    nq = -(-s // bq)
    spare = sm_count - bkv * nq
    tiles = [-(-min((qb + 1) * bq, s, kv_len) // WGMMA_KEYS) for qb in range(nq)]
    longer = sum(t >= 2 and t > tiles[-1] // 2 for t in tiles)
    return nq - min(longer, max(spare, 0) // bkv)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention over (bh, s, d) q and (bh, kv_len, d) k/v, in f32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, -torch.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True,
                              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the GQA kernel (materializes the scores).
    Causal rows at positions < s never see keys past s, so like the kernel
    it does not read them."""
    bkv, g, s, d = q.shape
    if causal:
        k, v = k[:, :s], v[:, :s]
    kr = k[:, None].expand(bkv, g, *k.shape[1:]).reshape(bkv * g, -1, d)
    vr = v[:, None].expand(bkv, g, *v.shape[1:]).reshape(bkv * g, -1, d)
    out = attention_reference(q.reshape(bkv * g, s, d), kr, vr, causal, sm_scale)
    return out.reshape(bkv, g, s, d)


def _flash_gqa_cuda(q, k, v, sm_scale):
    bkv, g, s, d = q.shape
    kv_len = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim {KERNEL_HEAD_DIMS}, got {d}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash kernel takes a group of 1 to {MAX_GROUP} heads, got {g}")
    if k.shape != (bkv, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kernels.require_cuda("flash_attention_gqa", q, k, v)
    out = torch.empty_like(q)
    nq = split_from = 0
    ws = tickets = None
    if d == 256 and q.dtype == torch.bfloat16:
        nq = -(-s // (WGMMA_ROWS // g))
        split_from = wgmma_split_from(bkv, g, s, kv_len, kernels.sm_count(q.device.index))
    if split_from < nq:
        slots = bkv * (nq - split_from)
        ws = torch.empty(slots * WGMMA_ROWS * WGMMA_PART_LD, dtype=torch.float32,
                         device=q.device)
        tickets = kernels.ticket_words(_SPLIT_TICKETS, q.device, 2 * slots)
    err = kernels.lib().rk_flash_gqa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bkv, g, s, kv_len, d,
        float(sm_scale), kernels.dtype_code(q.dtype), split_from,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        kernels.stream_handle(q.device))
    kernels.check(err, "flash_attention_gqa")
    kernels.count("flash_gqa", f"hd={d} g={g}")
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Grouped-query causal attention: q (b·nkv, g, s, hd), k/v
    (b·nkv, kv_len, hd) → (b·nkv, g, s, hd) in q's dtype.

    CUDA tensors launch the kernel (causal only; head_dim 128 or 256, a
    group of 1 to 64 heads, any other shape raises); CPU tensors take the
    plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        if not causal:
            raise ValueError("the flash kernel is causal only")
        return _flash_gqa_cuda(q, k, v, sm_scale)
    return flash_attention_gqa_plain(q, k, v, causal, sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """softmax(q k^T / √d) v for (bh, s, d) q and (bh, kv_len, d) k/v: the
    g = 1 case of ``flash_attention_gqa``."""
    return flash_attention_gqa(q[:, None], k, v, causal, sm_scale)[:, 0]


def span_attention_mass(q_span: torch.Tensor, k_full: torch.Tensor,
                        spans: Sequence[Tuple[int, int]], q_offset: int,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512) -> np.ndarray:
    """Mean causal-softmax attention mass from a (small) query span to each
    key span, computed blockwise over keys (attention provenance of long
    threads).

    q_span: (a, d) the span's post-RoPE queries of one head; k_full: (L, d)
    all keys; spans: [(lo, hi)] key spans; q_offset: the absolute position
    of q_span[0] (the causal mask). Two passes over ``block_k`` key blocks:
    each query row's softmax max and sum, then the normalized weights summed
    into the spans; memory O(a × block_k), the L×L matrix is never built.
    A plain torch function: the JAX package computes it in XLA, outside any
    Pallas kernel. → (len(spans),) f32 means over query rows and span
    length."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q_span.shape[-1])
    a = q_span.shape[0]
    L = k_full.shape[0]
    dev = q_span.device
    q32 = q_span.float()
    q_pos = q_offset + torch.arange(a, device=dev)
    span_arr = torch.as_tensor(np.asarray(spans, np.int64).reshape(-1, 2), device=dev)
    lo, hi = span_arr[:, 0], span_arr[:, 1]

    def block(k0):
        kb = k_full[k0:k0 + block_k].float()
        kv_pos = k0 + torch.arange(kb.shape[0], device=dev)
        s = (q32 @ kb.T) * sm_scale
        return torch.where(kv_pos[None, :] <= q_pos[:, None], s, -torch.inf), kv_pos

    # pass 1: each query row's softmax max and sum
    m = torch.full((a,), -torch.inf, device=dev)
    l = torch.zeros(a, device=dev)
    for k0 in range(0, L, block_k):
        s, _ = block(k0)
        m_next = torch.maximum(m, s.max(dim=1).values)
        l = (l * torch.exp(m - m_next)
             + torch.exp(torch.where(torch.isfinite(s), s - m_next[:, None], -torch.inf)
                         ).sum(dim=1))
        m = m_next
    l = l.clamp_min(1e-30)
    # pass 2: the normalized weights, summed into each span
    acc = torch.zeros(len(span_arr), device=dev)
    for k0 in range(0, L, block_k):
        s, kv_pos = block(k0)
        w = torch.exp(torch.where(torch.isfinite(s), s - m[:, None], -torch.inf)) / l[:, None]
        member = (kv_pos[None, :] >= lo[:, None]) & (kv_pos[None, :] < hi[:, None])
        acc = acc + torch.einsum("ak,sk->s", w, member.float())
    span_len = (hi - lo).float().clamp_min(1.0)
    return (acc / (a * span_len)).cpu().numpy()


# -- ring attention (context parallelism over a list of devices) -------------------

def ring_attention_local(q_blocks: Sequence[torch.Tensor], k_blocks: Sequence[torch.Tensor],
                         v_blocks: Sequence[torch.Tensor], causal: bool = True,
                         sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """The ring's per-shard bodies, run in turn by one process. Shard i
    holds the query block q_blocks[i] (bh, sq, d) and starts with the K/V
    block i (bh, skv, d), all on its device. At step t it attends the block
    that came from shard (i - t) mod n with online-softmax statistics in
    f32 (masked scores at MASK_VALUE, the row max m, the sum l, the output
    o), then hands the block on to shard i + 1. After n steps every shard
    has attended its queries over the whole sequence; a row with no key
    (l == 0) gives zeros. → each shard's (bh, sq, d) output in q's dtype."""
    n = len(q_blocks)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q_blocks[0].shape[-1])
    state = []
    for i, q in enumerate(q_blocks):
        bh, sq, d = q.shape
        state.append([torch.full((bh, sq, 1), -torch.inf, device=q.device),
                      torch.zeros((bh, sq, 1), device=q.device),
                      torch.zeros((bh, sq, d), device=q.device)])
    kb, vb = list(k_blocks), list(v_blocks)
    for step in range(n):
        for i, q in enumerate(q_blocks):
            m, l, o = state[i]
            src = (i - step) % n
            sq, skv = q.shape[1], kb[i].shape[1]
            s = torch.einsum("bqd,bkd->bqk", q.float(), kb[i].float()) * sm_scale
            if causal:
                q_pos = i * sq + torch.arange(sq, device=q.device)
                kv_pos = src * skv + torch.arange(skv, device=q.device)
                s = torch.where(kv_pos[None, None, :] <= q_pos[None, :, None], s, MASK_VALUE)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next)
            state[i] = [m_next, alpha * l + p.sum(dim=-1, keepdim=True),
                        alpha * o + torch.einsum("bqk,bkd->bqd", p, vb[i].float())]
        # shard i + 1 receives shard i's block
        kb = [kb[(i - 1) % n].to(q_blocks[i].device) for i in range(n)]
        vb = [vb[(i - 1) % n].to(q_blocks[i].device) for i in range(n)]
    out = []
    for q, (_, l, o) in zip(q_blocks, state):
        linv = torch.where(l == 0.0, 1.0, 1.0 / l)
        out.append((o * linv).to(q.dtype))
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   devices: Sequence, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of (bh, s, d) q over (bh, kv_len, d) k/v with the sequence
    split over ``devices`` (n blocks, s and kv_len multiples of n; a device
    may repeat): each block goes to its device, the K/V blocks rotate
    through the ring (``ring_attention_local``), and the outputs are
    concatenated on q's device. Equal to single-device attention."""
    n = len(devices)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"ring over {n} devices needs seq lengths ({q.shape[1]}, "
                         f"{k.shape[1]}) divisible by {n}")

    def split(t):
        return [blk.to(dev) for blk, dev in zip(t.chunk(n, dim=1), devices)]
    outs = ring_attention_local(split(q), split(k), split(v), causal, sm_scale)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
