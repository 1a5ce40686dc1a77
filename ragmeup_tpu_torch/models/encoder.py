"""BERT-class sentence encoder.

Counterpart of ``ragmeup_tpu/models/encoder.py``: token ids → post-LN BERT
→ mean pool → L2 normalize, with length-bucketed batches. Both corpus
embedding (ingest) and query embedding (search) go through
``SentenceEncoder.encode``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.models.layers import (LayerNorm, Mlp, MultiHeadAttention,
                                             normal_)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def tiny() -> "BertConfig":
        """Small config for tests."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, max_position=128)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.attention = MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                            cfg.head_dim, dt, device)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        dt, device)
        self.mlp = Mlp(cfg.hidden_size, cfg.intermediate_size, dt, device)
        self.output_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                     dt, device)

    def forward(self, x, mask):
        x = self.attention_norm(x + self.attention(x, mask))
        return self.output_norm(x + self.mlp(x))


class BertEncoder(nn.Module):
    """Token ids → contextual embeddings (post-LN BERT)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.token_embedding = nn.Parameter(
            torch.zeros(c.vocab_size, c.hidden_size, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(c.max_position, c.hidden_size, device=device))
        self.type_embedding = nn.Parameter(
            torch.zeros(c.type_vocab_size, c.hidden_size, device=device))
        self.embed_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                    c.torch_dtype, device)
        self.layers = nn.ModuleList(BertLayer(c, device)
                                    for _ in range(c.num_layers))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: normal(0.02) embeddings, xavier kernels."""
        for p in (self.token_embedding, self.position_embedding,
                  self.type_embedding):
            normal_(p, generator)
        for layer in self.layers:
            layer.attention.init_weights(generator)
            layer.mlp.init_weights(generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.token_embedding[input_ids]
             + self.position_embedding[None, :s, :]
             + self.type_embedding[token_type_ids])
        x = self.embed_norm(x.to(self.cfg.torch_dtype))
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    m = attention_mask[..., None].to(hidden.dtype)
    summed = (hidden * m).sum(dim=1)
    count = torch.clamp_min(m.sum(dim=1), 1e-9)
    return summed / count


def _bucket_len(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class SentenceEncoder:
    """Tokenize → bucketed batched forward → mean pool → L2 normalize."""

    LENGTH_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, cfg: BertConfig, tokenizer,
                 model: Optional[BertEncoder] = None, seed: int = 0,
                 batch_size: int = 256, device=None):
        """``model``: a BertEncoder with loaded weights; None draws a
        deterministic random init from ``seed`` on ``device``."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        if model is None:
            model = BertEncoder(cfg, device=resolve_device(device))
            gen = torch.Generator(device=model.token_embedding.device)
            model.init_weights(gen.manual_seed(seed))
        self.model = model.eval()
        self.device = _device_of(self.model)

    @torch.inference_mode()
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        hidden = self.model(ids, mask)
        pooled = mean_pool(hidden.float(), mask)
        return pooled / torch.clamp_min(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)

    def _pad_batch(self, encs: List[List[int]]):
        max_len = max(len(e) for e in encs)
        L = min(_bucket_len(max_len, self.LENGTH_BUCKETS), self.cfg.max_position)
        ids = np.zeros((len(encs), L), np.int64)
        mask = np.zeros((len(encs), L), np.int64)
        for i, e in enumerate(encs):
            e = e[:L]
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return ids, mask

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Embed texts → (n, hidden) float32, L2-normalized."""
        if not len(texts):
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        encs = [self.tokenizer.encode(t) for t in texts]
        # sort by length to minimize padding waste, then restore order
        order = np.argsort([len(e) for e in encs], kind="stable")
        out = np.zeros((len(texts), self.cfg.hidden_size), np.float32)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            sel = order[i:i + bs]
            ids, mask = self._pad_batch([encs[j] for j in sel])
            emb = self._forward(torch.from_numpy(ids).to(self.device),
                                torch.from_numpy(mask).to(self.device))
            out[sel] = emb.cpu().numpy()
        return out

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
