"""Cross-encoder reranker: batched (query, doc) pair scoring on the device.

Counterpart of ``ragmeup_tpu/models/cross_encoder.py``: the candidate pairs
are packed into padded, length-bucketed batches, scored by a BERT trunk and
a pooler + classifier head over [CLS], and sorted on the host. The score is
written into each doc's metadata as ``relevance_score``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ragmeup_tpu.data.documents import Chunk
from ragmeup_tpu_torch.models.encoder import (BertConfig, BertEncoder,
                                              _bucket_len, _device_of)
from ragmeup_tpu_torch.models.layers import xavier_uniform_


class CrossEncoderModel(nn.Module):
    """BERT trunk + single-logit classification head over [CLS]."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.bert = BertEncoder(cfg, device)
        self.pooler_kernel = nn.Parameter(torch.zeros(h, h, device=device))
        self.pooler_bias = nn.Parameter(torch.zeros(h, device=device))
        self.classifier_kernel = nn.Parameter(torch.zeros(h, 1, device=device))
        self.classifier_bias = nn.Parameter(torch.zeros(1, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        self.bert.init_weights(generator)
        xavier_uniform_(self.pooler_kernel, generator)
        xavier_uniform_(self.classifier_kernel, generator)

    def forward(self, input_ids, attention_mask, token_type_ids):
        h = self.bert(input_ids, attention_mask, token_type_ids)
        cls = h[:, 0, :].float()
        # pooler (tanh) then classifier, matching BERT sequence classification
        pooled = torch.tanh(cls @ self.pooler_kernel + self.pooler_bias)
        return (pooled @ self.classifier_kernel + self.classifier_bias)[:, 0]


class CrossEncoder:
    """score(pairs) → np.ndarray; rerank(query, chunks) → top_n chunks."""

    LENGTH_BUCKETS = (64, 128, 256, 512)

    def __init__(self, cfg: BertConfig, tokenizer,
                 model: Optional[CrossEncoderModel] = None, seed: int = 1,
                 batch_size: int = 64, max_len: int = 512,
                 apply_sigmoid: bool = True, device=None):
        """``model``: a CrossEncoderModel with loaded weights; None draws a
        deterministic random init from ``seed`` on ``device``."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_len = min(max_len, cfg.max_position)
        self.apply_sigmoid = apply_sigmoid
        if model is None:
            model = CrossEncoderModel(cfg, device=device)
            gen = torch.Generator(device=model.pooler_bias.device)
            model.init_weights(gen.manual_seed(seed))
        self.model = model.eval()
        self.device = _device_of(self.model)

    @torch.inference_mode()
    def score(self, pairs: Sequence[Sequence[str]]) -> np.ndarray:
        """Score (query, doc) pairs; one forward per length bucket."""
        if not len(pairs):
            return np.zeros((0,), np.float32)
        encs = [self.tokenizer.encode_pair(q, d, max_len=self.max_len)
                for q, d in pairs]
        order = np.argsort([len(ids) for ids, _ in encs], kind="stable")
        out = np.zeros(len(pairs), np.float32)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            sel = order[i:i + bs]
            max_l = max(len(encs[j][0]) for j in sel)
            L = min(_bucket_len(max_l, self.LENGTH_BUCKETS), self.max_len)
            ids = np.zeros((len(sel), L), np.int64)
            mask = np.zeros((len(sel), L), np.int64)
            types = np.zeros((len(sel), L), np.int64)
            for r, j in enumerate(sel):
                e, t = encs[j]
                e, t = e[:L], t[:L]
                ids[r, :len(e)] = e
                mask[r, :len(e)] = 1
                types[r, :len(t)] = t
            logits = self.model(*(torch.from_numpy(a).to(self.device)
                                  for a in (ids, mask, types)))
            out[sel] = logits.cpu().numpy()
        if self.apply_sigmoid:
            out = 1.0 / (1.0 + np.exp(-out))
        return out

    def rerank(self, query: str, chunks: List[Chunk],
               top_n: Optional[int] = None) -> List[Chunk]:
        """Sort chunks by cross-encoder score desc, keep top_n, write
        relevance_score metadata."""
        if not chunks:
            return []
        scores = self.score([(query, c.content) for c in chunks])
        order = np.argsort(-scores, kind="stable")
        if top_n:
            order = order[:top_n]
        out = []
        for i in order:
            c = chunks[int(i)]
            md = dict(c.metadata)
            md["relevance_score"] = float(scores[int(i)])
            out.append(Chunk(content=c.content, metadata=md, id=c.id))
        return out
