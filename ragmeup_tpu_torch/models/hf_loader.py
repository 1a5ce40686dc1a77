"""Model factories and post-load quantization.

Counterpart of ``ragmeup_tpu/models/hf_loader.py`` for the no-checkpoint
case: ``load_sentence_encoder``, ``load_cross_encoder`` and
``load_local_llm`` build the same configurations the JAX package builds
without a checkpoint, with a deterministic random init. Loading safetensors
checkpoints is not ported yet and raises.

``select_kernels`` is the JAX loader's kernel selection as a function of
the config (flash prefill when head_dim % 128 == 0, the int8 decode kernel
for int8 weights, the 512-row scale group that W4A8 needs);
``quantize_decoder_params`` its int8 and int4 branches, for dense kernels
and for the stacked experts of MoE layers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from ragmeup_tpu_torch.models.cross_encoder import CrossEncoder
from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM,
                                              quantize_experts_int4,
                                              quantize_experts_int8,
                                              quantize_kernel_int8)
from ragmeup_tpu_torch.models.encoder import BertConfig, SentenceEncoder
from ragmeup_tpu_torch.models.tokenizer import load_tokenizer
from ragmeup_tpu_torch.ops.quant_matmul import quantize_int4_groupwise


def _no_checkpoints(checkpoint_dir: Optional[str]) -> None:
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        raise NotImplementedError(
            f"loading the checkpoint {checkpoint_dir} is not ported yet "
            "(ROADMAP queue 1: safetensors checkpoint loading)")


def select_kernels(cfg: LlamaConfig) -> LlamaConfig:
    """Turn on the flash prefill when the head dim is a multiple of 128 and
    the int8 decode kernel for int8 weights; W4A8 int4 weights take the
    output-scaled layout it needs (``int4_group`` = the 512-row k-tile)."""
    if cfg.head_dim % 128 == 0:
        cfg = dataclasses.replace(cfg, use_flash=True)
    if cfg.quantization == "int8":
        cfg = dataclasses.replace(cfg, quant_kernel=True)
    if cfg.quantization == "int4" and cfg.int4_w4a8:
        cfg = dataclasses.replace(cfg, int4_group=512)
    return cfg


def quantize_decoder_params(params: Dict[str, torch.Tensor], bits: int = 8,
                            embeddings_bf16: bool = True, int4_group: int = 0
                            ) -> Dict[str, torch.Tensor]:
    """Post-load weight-only quantization, computed where each tensor lives.
    int8: every 2-D ``*.kernel`` becomes ``*.kernel_q`` (int8, same (in, out)
    layout) + ``*.scale`` (f32 per-output-channel). int4: ``*.kernel_p``
    (packed (in/2, out)) + ``*.gscale`` (f32 (in/group, out); ``int4_group``
    0 = the default group). MoE layers: each stacked expert tensor
    ``*.mlp.{gate,up,down}`` (E, in, out) becomes, int8, ``*_q`` (int8) +
    ``*_s`` (f32 (E, out), per expert per output channel), or, int4, ``*_p``
    (packed (E, in/2, out)) + ``*_gs`` (f32 (E, in/group, out)), each expert
    quantized as a dense kernel is; the router stays f32.
    token_embedding and lm_head are stored in bf16."""
    if bits not in (4, 8):
        raise NotImplementedError(f"{bits}-bit quantization is not ported")
    out: Dict[str, torch.Tensor] = {}
    for name, w in params.items():
        if name.endswith((".mlp.gate", ".mlp.up", ".mlp.down")) and w.ndim == 3:
            if bits == 4:
                out[f"{name}_p"], out[f"{name}_gs"] = quantize_experts_int4(w, int4_group)
            else:
                out[f"{name}_q"], out[f"{name}_s"] = quantize_experts_int8(w)
        elif name.endswith(".kernel") and w.ndim == 2:
            base = name[:-len(".kernel")]
            if bits == 4:
                out[f"{base}.kernel_p"], out[f"{base}.gscale"] = \
                    quantize_int4_groupwise(w, group=int4_group or None)
            else:
                out[f"{base}.kernel_q"], out[f"{base}.scale"] = \
                    quantize_kernel_int8(w)
        elif embeddings_bf16 and name in ("token_embedding", "lm_head"):
            out[name] = w.to(torch.bfloat16)
        else:
            out[name] = w
    return out


def load_sentence_encoder(checkpoint_dir: Optional[str], dim: int = 384,
                          seed: int = 0, batch_size: int = 256, device=None):
    """Deterministic random-init encoder (the JAX no-checkpoint config)."""
    _no_checkpoints(checkpoint_dir)
    cfg = BertConfig(hidden_size=dim, num_layers=4, num_heads=max(dim // 64, 1),
                     intermediate_size=dim * 4)
    tok = load_tokenizer(None, cfg.vocab_size)
    return SentenceEncoder(cfg, tok, seed=seed, batch_size=batch_size,
                           device=device)


def load_cross_encoder(checkpoint_dir: Optional[str], seed: int = 1,
                       batch_size: int = 64, kind: str = "cross-encoder",
                       device=None):
    """Rerank model: 'flashrank'/'tiny'/'fast' builds the FlashRank-class
    small cross-encoder (2 layers, hidden 128, short pairs, large batch);
    anything else the tiny BERT the JAX package uses without a checkpoint."""
    _no_checkpoints(checkpoint_dir)
    if kind in ("flashrank", "tiny", "fast"):
        cfg = BertConfig(vocab_size=30522, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=512, max_position=512)
        tok = load_tokenizer(None, cfg.vocab_size)
        return CrossEncoder(cfg, tok, seed=seed, batch_size=max(batch_size, 128),
                            max_len=128, device=device)
    cfg = BertConfig.tiny()
    tok = load_tokenizer(None, cfg.vocab_size)
    return CrossEncoder(cfg, tok, seed=seed, batch_size=batch_size, device=device)


def load_local_llm(checkpoint_dir: Optional[str], seed: int = 0, device=None,
                   quantization: str = "none", int4_w4a8: bool = False,
                   int4_group: int = 0, max_seq_len: int = 0):
    """The local chat LLM without a checkpoint: the tiny deterministic
    random-init model of the JAX package, which ignores the checkpoint
    settings (``quantization``, ``int4_w4a8``, ``int4_group``,
    ``max_seq_len``) without a checkpoint as well."""
    _no_checkpoints(checkpoint_dir)
    cfg = LlamaConfig.tiny()
    tok = load_tokenizer(None, cfg.vocab_size)
    return LocalLLM(cfg, tok, seed=seed, device=device)
