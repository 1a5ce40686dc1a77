"""Causal flash attention (forward, grouped-query): CUDA kernel and plain version.

Counterpart of ``ragmeup_tpu/ops/attention.py``: ``flash_attention_gqa``
takes q ``(b·nkv, g, s, hd)`` (the g query heads of one kv head together)
against k/v ``(b·nkv, kv_len, hd)`` at the native kv-head count;
``flash_attention`` is its g = 1 case with q ``(bh, s, hd)``. The mask is
causal over absolute positions 0..s-1, so keys past s (the unused tail of a
KV cache, kv_len ≥ s) are hidden from every row. csrc/flash_attention.cu
keeps the score tile on chip; see its header.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

from ragmeup_tpu_torch import kernels

KERNEL_HEAD_DIM = 128


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
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim {KERNEL_HEAD_DIM}, got {d}")
    if g > 64 or g & (g - 1):
        raise ValueError(f"flash kernel takes a power-of-two group <= 64, got {g}")
    if k.shape != (bkv, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kernels.require_cuda("flash_attention_gqa", q, k, v)
    out = torch.empty_like(q)
    err = kernels.lib().rk_flash_gqa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bkv, g, s, kv_len,
        float(sm_scale), kernels.dtype_code(q.dtype), out.data_ptr(),
        kernels.stream_handle(q.device))
    kernels.check(err, "flash_attention_gqa")
    kernels.count("flash_gqa")
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Grouped-query causal attention: q (b·nkv, g, s, hd), k/v
    (b·nkv, kv_len, hd) → (b·nkv, g, s, hd) in q's dtype.

    CUDA tensors launch the kernel (causal only); CPU tensors take the
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
