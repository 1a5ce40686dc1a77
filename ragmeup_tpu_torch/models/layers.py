"""Shared building blocks as ``nn.Module``s.

Counterpart of ``ragmeup_tpu/models/layers.py``. Parameters keep the JAX
package's names and layouts: a ``*_kernel`` is ``(in, out)`` and a layer
computes ``x @ kernel + bias``, so converted flax weights load as they are
(``models/convert.py``). Norms keep ``scale``/``bias`` and compute in f32.
Each module takes ``dtype`` (the compute dtype; parameters stay f32, cast
at use, as the flax modules do) and ``device``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's xavier_uniform for an (in, out) kernel."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-lim, lim, generator=generator)


def normal_(t: torch.Tensor, generator: torch.Generator,
            std: float = 0.02) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class MultiHeadAttention(nn.Module):
    """Standard MHA (BERT-style, bidirectional unless the mask says otherwise)."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        feat = num_heads * head_dim
        for name in ("query", "key", "value"):
            self.register_parameter(f"{name}_kernel", nn.Parameter(
                torch.zeros(d_model, feat, device=device)))
            self.register_parameter(f"{name}_bias", nn.Parameter(
                torch.zeros(feat, device=device)))
        self.out_kernel = nn.Parameter(torch.zeros(feat, d_model, device=device))
        self.out_bias = nn.Parameter(torch.zeros(d_model, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        for name in ("query", "key", "value", "out"):
            xavier_uniform_(getattr(self, f"{name}_kernel"), generator)

    def _proj(self, name: str, y: torch.Tensor) -> torch.Tensor:
        k = getattr(self, f"{name}_kernel").to(self.dtype)
        b = getattr(self, f"{name}_bias").to(self.dtype)
        out = y @ k + b
        return out.reshape(*y.shape[:-1], self.num_heads, self.head_dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self._proj("query", x)
        k = self._proj("key", x)
        v = self._proj("value", x)
        # 1 / sqrt(hd) rounded as the flax module rounds it (sqrt in f32,
        # cast to the compute dtype, then the reciprocal in that dtype)
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.head_dim))).to(self.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * scale.float().to(q.device)
        if mask is not None:
            # mask: (b, k) 1 = attend, 0 = pad
            bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        out = out.reshape(*x.shape[:-1], self.num_heads * self.head_dim)
        return out @ self.out_kernel.to(self.dtype) + self.out_bias.to(self.dtype)


class Mlp(nn.Module):
    """Dense → GELU (exact erf) → dense."""

    def __init__(self, d_model: int, intermediate: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.wi_kernel = nn.Parameter(torch.zeros(d_model, intermediate, device=device))
        self.wi_bias = nn.Parameter(torch.zeros(intermediate, device=device))
        self.wo_kernel = nn.Parameter(torch.zeros(intermediate, d_model, device=device))
        self.wo_bias = nn.Parameter(torch.zeros(d_model, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.wi_kernel, generator)
        xavier_uniform_(self.wo_kernel, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi_kernel.to(self.dtype) + self.wi_bias.to(self.dtype)
        h = F.gelu(h, approximate="none")
        return h @ self.wo_kernel.to(self.dtype) + self.wo_bias.to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype)


class RMSNorm(nn.Module):
    """RMS norm in f32 with a learned scale. ``offset`` 1.0 is the Gemma
    convention, where the stored weight is the scale less one (HF
    GemmaRMSNorm multiplies by ``1 + weight``)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None,
                 offset: float = 0.0):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.offset = offset
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        scale = self.scale + self.offset if self.offset else self.scale
        return (x32 * torch.rsqrt(var + self.eps) * scale).to(self.dtype)
