"""HF safetensors checkpoints → the port's models; the random-init
factories; post-load quantization.

Counterpart of ``ragmeup_tpu/models/hf_loader.py``. ``load_sentence_encoder``,
``load_cross_encoder`` and ``load_local_llm`` load a checkpoint directory
(config.json, ``*.safetensors`` read by ``models/safetensors.py``, a
tokenizer if it ships one) when they are given one, and otherwise build the
configurations the JAX package builds without a checkpoint, with a
deterministic random init. Decoders load from every Llama-layout family
the JAX package loads (``FAMILIES``: Llama, Mistral, Qwen2, Qwen3, Phi-3,
Gemma, Gemma-2, Mixtral, Qwen3-MoE); the family's branches are
``LlamaConfig`` fields.

Torch ``nn.Linear`` weights are ``(out, in)``; the port's modules keep the
JAX package's ``(in, out)`` kernels under its names (``convert.py``), so
each weight is transposed here. ``llama_params_from_hf`` is the generic
path: every tensor widened to f32 on the host, as the JAX package widens
it. ``llama_int8_params_from_hf`` and ``llama_int4_params_from_hf`` stream
instead: each checkpoint tensor moves to the target device once, in its
source dtype, and is transposed and quantized there by the same functions
``quantize_decoder_params`` runs, so on one device their codes and scales
are byte-equal to the generic path's and never return to the host.

``select_kernels`` is the JAX loader's kernel selection for the random-init
callers (flash prefill when head_dim % 128 == 0, the int8 decode kernel for
int8 weights, the 512-row scale group that W4A8 needs).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional

import torch

from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.models.cross_encoder import CrossEncoder, CrossEncoderModel
from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LocalLLM, int4_tiles,
                                              quantize_experts_int4,
                                              quantize_experts_int8,
                                              quantize_kernel_int8, sharded_mesh)
from ragmeup_tpu_torch.models.encoder import BertConfig, BertEncoder, SentenceEncoder
from ragmeup_tpu_torch.models.safetensors import load_safetensors
from ragmeup_tpu_torch.models.tokenizer import load_tokenizer
from ragmeup_tpu_torch.ops.quant_matmul import quantize_int4_groupwise
from ragmeup_tpu_torch.parallel.mesh import canonical

Tensors = Dict[str, torch.Tensor]

# the Llama-layout model_type values both packages load
FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "phi3", "gemma",
            "gemma2", "mixtral", "qwen3_moe")
# a layer's norms that are not in every family: HF name → the port's
_EXTRA_NORMS = (("pre_feedforward_layernorm", "pre_ffw_norm"),       # gemma2
                ("post_feedforward_layernorm", "post_ffw_norm"))


def _strip_prefix(tensors: Tensors) -> Tensors:
    """Normalize 'bert.' / 'roberta.' / 'model.' prefixes away."""
    out = {}
    for k, v in tensors.items():
        for pref in ("bert.", "roberta.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
                break
        out[k] = v
    return out


def _kernel(t: torch.Tensor) -> torch.Tensor:
    """A torch Linear weight (out, in) → an f32 (in, out) kernel."""
    return t.float().T.contiguous()


# ---------------------------------------------------------------------------
# BERT encoders
# ---------------------------------------------------------------------------

def bert_params_from_hf(tensors: Tensors, num_layers: int) -> Tensors:
    """BertEncoder state dict (f32) from HF BERT-style tensors."""
    t = _strip_prefix(tensors)
    out = {
        "token_embedding": t["embeddings.word_embeddings.weight"].float(),
        "position_embedding": t["embeddings.position_embeddings.weight"].float(),
        "type_embedding": t["embeddings.token_type_embeddings.weight"].float(),
        "embed_norm.scale": t["embeddings.LayerNorm.weight"].float(),
        "embed_norm.bias": t["embeddings.LayerNorm.bias"].float(),
    }
    for i in range(num_layers):
        p, q = f"encoder.layer.{i}.", f"layers.{i}."
        for ours, hf in (("query", "attention.self.query"), ("key", "attention.self.key"),
                         ("value", "attention.self.value"),
                         ("out", "attention.output.dense")):
            out[f"{q}attention.{ours}_kernel"] = _kernel(t[f"{p}{hf}.weight"])
            out[f"{q}attention.{ours}_bias"] = t[f"{p}{hf}.bias"].float()
        for ours, hf in (("attention_norm", "attention.output.LayerNorm"),
                         ("output_norm", "output.LayerNorm")):
            out[f"{q}{ours}.scale"] = t[f"{p}{hf}.weight"].float()
            out[f"{q}{ours}.bias"] = t[f"{p}{hf}.bias"].float()
        for ours, hf in (("wi", "intermediate.dense"), ("wo", "output.dense")):
            out[f"{q}mlp.{ours}_kernel"] = _kernel(t[f"{p}{hf}.weight"])
            out[f"{q}mlp.{ours}_bias"] = t[f"{p}{hf}.bias"].float()
    return out


def cross_encoder_params_from_hf(tensors: Tensors, num_layers: int) -> Tensors:
    """CrossEncoderModel state dict (bert + pooler + a one-logit classifier);
    a head the checkpoint lacks (or a classifier of more than one logit) is
    left out for the caller to fill."""
    t = _strip_prefix(tensors)
    out = {f"bert.{k}": v for k, v in bert_params_from_hf(tensors, num_layers).items()}
    if "pooler.dense.weight" in t:
        out["pooler_kernel"] = _kernel(t["pooler.dense.weight"])
        out["pooler_bias"] = t["pooler.dense.bias"].float()
    if "classifier.weight" in t and t["classifier.weight"].shape[0] == 1:
        out["classifier_kernel"] = _kernel(t["classifier.weight"])
        out["classifier_bias"] = t["classifier.bias"].float()
    return out


def _read_config(checkpoint_dir: str) -> dict:
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        return json.load(f)


def bert_config_from_hf(checkpoint_dir: str) -> BertConfig:
    """config.json → BertConfig."""
    c = _read_config(checkpoint_dir)
    return BertConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
    )


def _is_checkpoint(checkpoint_dir: Optional[str]) -> bool:
    return bool(checkpoint_dir) and os.path.isdir(checkpoint_dir)


def load_sentence_encoder(checkpoint_dir: Optional[str], dim: int = 384,
                          seed: int = 0, batch_size: int = 256, device=None):
    """The embedding model: a BERT checkpoint directory if given, else the
    deterministic random-init encoder of the JAX no-checkpoint config."""
    if _is_checkpoint(checkpoint_dir):
        dev = resolve_device(device)
        cfg = bert_config_from_hf(checkpoint_dir)
        model = BertEncoder(cfg, device=dev)
        model.load_state_dict(bert_params_from_hf(load_safetensors(checkpoint_dir),
                                                  cfg.num_layers), strict=True)
        tok = load_tokenizer(checkpoint_dir, cfg.vocab_size)
        return SentenceEncoder(cfg, tok, model=model, batch_size=batch_size)
    cfg = BertConfig(hidden_size=dim, num_layers=4, num_heads=max(dim // 64, 1),
                     intermediate_size=dim * 4)
    tok = load_tokenizer(None, cfg.vocab_size)
    return SentenceEncoder(cfg, tok, seed=seed, batch_size=batch_size,
                           device=device)


def load_cross_encoder(checkpoint_dir: Optional[str], seed: int = 1,
                       batch_size: int = 64, kind: str = "cross-encoder",
                       device=None):
    """Rerank model. A checkpoint directory loads as a BERT cross-encoder;
    a head it lacks keeps the port's own init from ``seed``. ``kind``
    'flashrank'/'tiny'/'fast' takes the FlashRank-class settings (short
    pairs, a large batch) and, without a checkpoint, its small model (2
    layers, hidden 128); any other kind without a checkpoint the tiny BERT
    the JAX package uses."""
    fast = kind in ("flashrank", "tiny", "fast")
    settings = dict(batch_size=max(batch_size, 128), max_len=128) if fast else \
        dict(batch_size=batch_size)
    if _is_checkpoint(checkpoint_dir):
        dev = resolve_device(device)
        cfg = bert_config_from_hf(checkpoint_dir)
        params = cross_encoder_params_from_hf(load_safetensors(checkpoint_dir),
                                              cfg.num_layers)
        model = CrossEncoderModel(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        for k, v in model.state_dict().items():
            params.setdefault(k, v)
        model.load_state_dict(params, strict=True)
        tok = load_tokenizer(checkpoint_dir, cfg.vocab_size)
        return CrossEncoder(cfg, tok, model=model, **settings)
    if fast:
        cfg = BertConfig(vocab_size=30522, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=512, max_position=512)
    else:
        cfg = BertConfig.tiny()
    tok = load_tokenizer(None, cfg.vocab_size)
    return CrossEncoder(cfg, tok, seed=seed, device=device, **settings)


# ---------------------------------------------------------------------------
# Llama-layout decoders
# ---------------------------------------------------------------------------

def llama_config_from_hf(checkpoint_dir: str, quantization: str = "none",
                         max_seq_len: int = 0) -> LlamaConfig:
    """config.json → LlamaConfig for every Llama-layout family of the JAX
    package (``FAMILIES``), field by field as its ``llama_config_from_hf``
    maps them: Qwen2's biases, Mistral's and Phi-3's sliding window (Qwen's
    behind ``use_sliding_window``), Gemma-2's per-layer windows
    (``layer_types``, or the even layers), softcaps and
    ``query_pre_attn_scalar``, Gemma's tied head, offset norms and
    embedding scale, Qwen3's q/k norms, the MoE fields of Mixtral and
    Qwen3-MoE (``decoder_sparse_step`` / ``mlp_only_layers``), rope
    scaling and the context cap. What the JAX package refuses (another
    model_type, activation or rope scaling, such as Phi-3's longrope)
    raises its ValueError."""
    c = _read_config(checkpoint_dir)
    mt = c.get("model_type", "llama")
    if mt not in FAMILIES:
        raise ValueError(
            f"unsupported model_type {mt!r} in {checkpoint_dir}/config.json "
            "(supported Llama-layout families: llama, mistral, qwen2, "
            "qwen3, phi3, gemma, gemma2, mixtral, qwen3_moe)")
    moe_kw = {}
    if mt == "mixtral":  # top-k of num_local_experts, always renormalized
        moe_kw = dict(num_experts=int(c["num_local_experts"]),
                      num_experts_per_tok=int(c["num_experts_per_tok"]),
                      norm_topk_prob=True)
    elif mt == "qwen3_moe":
        step = int(c.get("decoder_sparse_step", 1))
        only = set(c.get("mlp_only_layers") or ())
        flags = tuple(i not in only and step > 0 and (i + 1) % step == 0
                      for i in range(c["num_hidden_layers"]))
        moe_kw = dict(num_experts=int(c["num_experts"]),
                      num_experts_per_tok=int(c["num_experts_per_tok"]),
                      moe_intermediate_size=int(c["moe_intermediate_size"]),
                      norm_topk_prob=bool(c.get("norm_topk_prob", True)),
                      moe_layers=() if all(flags) else flags)
    # Qwen's window applies to every layer when use_sliding_window is set
    # (its max_window_layers refinement is not reproduced, as in JAX)
    sw = c.get("sliding_window") or 0
    if mt in ("qwen2", "qwen3", "qwen3_moe") and not c.get("use_sliding_window", False):
        sw = 0
    layer_windows = ()
    if mt == "gemma2" and sw:
        lt = c.get("layer_types")
        layer_windows = tuple(
            (int(sw) if t == "sliding_attention" else 0 for t in lt) if lt else
            (int(sw) if i % 2 == 0 else 0 for i in range(c["num_hidden_layers"])))
    # Gemma's gelu and gelu_pytorch_tanh are both HF's tanh approximation
    act = c.get("hidden_activation") or c.get("hidden_act") or "silu"
    act_map = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh",
               "gelu": "gelu_tanh" if mt.startswith("gemma") else "gelu"}
    if act not in act_map:
        raise ValueError(f"unsupported hidden activation {act!r} in "
                         f"{checkpoint_dir}/config.json")
    rs = c.get("rope_scaling") or {}
    rs_type = rs.get("rope_type", rs.get("type", "none")) if rs else "none"
    rs_kw = {}
    if rs_type in ("llama3", "linear"):
        rs_kw = dict(
            rope_scaling_type=rs_type,
            rope_scaling_factor=float(rs.get("factor", 1.0)),
            rope_scaling_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_scaling_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_scaling_original_max_position=int(
                rs.get("original_max_position_embeddings",
                       c.get("max_position_embeddings", 8192))))
    elif rs_type not in ("none", "default"):
        raise ValueError(
            f"unsupported rope_scaling type {rs_type!r} in "
            f"{checkpoint_dir}/config.json (supported: llama3, linear)")
    gemma = mt.startswith("gemma")
    return LlamaConfig(
        **rs_kw,
        **moe_kw,
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        intermediate_size=c["intermediate_size"],
        rope_theta=c.get("rope_theta", 10000.0),
        # the dense cache's context cap; model.llm_max_seq_len raises it
        max_seq_len=min(c.get("max_position_embeddings", 8192),
                        max_seq_len or 32768),
        rms_eps=c.get("rms_norm_eps", 1e-5),
        tie_embeddings=c.get("tie_word_embeddings", gemma),
        qkv_bias=bool(c.get("attention_bias", mt == "qwen2")),
        sliding_window=int(sw),
        head_dim_override=int(c.get("head_dim") or 0),
        act_fn=act_map[act],
        norm_offset=1.0 if gemma else 0.0,
        embed_scale=gemma,
        qk_norm=mt in ("qwen3", "qwen3_moe"),
        post_norms=mt == "gemma2",
        attn_softcap=float(c.get("attn_logit_softcapping") or 0.0),
        final_softcap=float(c.get("final_logit_softcapping") or 0.0),
        query_scale=(float(c["query_pre_attn_scalar"]) ** -0.5
                     if c.get("query_pre_attn_scalar") else 0.0),
        layer_windows=layer_windows,
        quantization=quantization,
    )


def split_packed_tensors(tensors: Tensors, num_heads: int, num_kv_heads: int,
                         head_dim: int) -> Tensors:
    """Phi-3's packed ``qkv_proj`` (rows [q; k; v]) and ``gate_up_proj``
    (rows [gate; up]) under the standard Llama names, as row views of the
    (out, in) tensors: no copy."""
    qh, kvh = num_heads * head_dim, num_kv_heads * head_dim
    out: Tensors = {}
    for k, v in tensors.items():
        if k.endswith("self_attn.qkv_proj.weight"):
            base = k[:-len("qkv_proj.weight")]
            out[base + "q_proj.weight"] = v[:qh]
            out[base + "k_proj.weight"] = v[qh:qh + kvh]
            out[base + "v_proj.weight"] = v[qh + kvh:]
        elif k.endswith("mlp.gate_up_proj.weight"):
            base = k[:-len("gate_up_proj.weight")]
            inter = v.shape[0] // 2
            out[base + "gate_proj.weight"] = v[:inter]
            out[base + "up_proj.weight"] = v[inter:]
        else:
            out[k] = v
    return out


def _moe_layer_tensors(t: Tensors, p: str):
    """One layer's MoE tensors in torch (out, in) layout, or None if its MLP
    is dense: (router (E, h), gates, ups, downs), a list of experts each.
    Mixtral stores experts at ``block_sparse_moe.experts.{e}.w1/w3/w2``
    (gate/up/down); Qwen3-MoE at ``mlp.experts.{e}.gate_proj/up_proj/
    down_proj``."""
    if p + "block_sparse_moe.gate.weight" in t:       # mixtral
        rw = t[p + "block_sparse_moe.gate.weight"]
        base = p + "block_sparse_moe.experts."
        names = ("w1", "w3", "w2")
    elif p + "mlp.gate.weight" in t:                  # qwen3_moe
        rw = t[p + "mlp.gate.weight"]
        base = p + "mlp.experts."
        names = ("gate_proj", "up_proj", "down_proj")
    else:
        return None
    return (rw,) + tuple([t[f"{base}{e}.{name}.weight"] for e in range(rw.shape[0])]
                         for name in names)


def _layer_extras(t: Tensors, p: str, load) -> Tensors:
    """One layer's tensors beyond the Llama set, unquantized through
    ``load``: the q/k/v biases (Qwen2), ``q_norm``/``k_norm`` (Qwen3) and
    Gemma-2's feed-forward norms, under the port's names."""
    out: Tensors = {}
    q = f"{p}attention."
    for proj in ("q_proj", "k_proj", "v_proj"):
        if f"{p}self_attn.{proj}.bias" in t:
            out[f"{q}{proj}.bias"] = load(t[f"{p}self_attn.{proj}.bias"])
    for nrm in ("q_norm", "k_norm"):
        if f"{p}self_attn.{nrm}.weight" in t:
            out[f"{q}{nrm}.scale"] = load(t[f"{p}self_attn.{nrm}.weight"])
    for hf, ours in _EXTRA_NORMS:
        if f"{p}{hf}.weight" in t:
            out[f"{p}{ours}.scale"] = load(t[f"{p}{hf}.weight"])
    return out


def llama_params_from_hf(tensors: Tensors, num_layers: int, tie_embeddings: bool,
                         layers: Optional[Iterable[int]] = None,
                         fused_projections: bool = False) -> Tensors:
    """HF Llama-layout tensors → LlamaModel state dict, every tensor f32 on
    the host (torch Linear weights transposed into (in, out) kernels; MoE
    experts stacked (E, in, out), the router (h, E); biases and norms as
    they are). ``layers`` converts only those layers (default: all
    ``num_layers``). ``fused_projections`` concatenates the q/k/v kernels
    (and biases) into ``qkv_proj`` and gate/up into ``gate_up_proj``, as
    the JAX loader does (which also leaves out q/k norms there; here they
    stay, so a fused Qwen3 loads)."""
    t = _strip_prefix(tensors)
    out = {"token_embedding": t["embed_tokens.weight"].float(),
           "final_norm.scale": t["norm.weight"].float()}
    if not tie_embeddings and "lm_head.weight" in tensors:
        out["lm_head"] = _kernel(tensors["lm_head.weight"])
    for i in (range(num_layers) if layers is None else layers):
        p = f"layers.{i}."
        a = f"{p}attention."
        extras = _layer_extras(t, p, lambda w: w.float())
        if fused_projections:
            out[f"{a}qkv_proj.kernel"] = torch.cat(
                [_kernel(t[f"{p}self_attn.{proj}.weight"])
                 for proj in ("q_proj", "k_proj", "v_proj")], dim=1)
            biases = [extras.pop(f"{a}{proj}.bias", None)
                      for proj in ("q_proj", "k_proj", "v_proj")]
            if biases[0] is not None:
                out[f"{a}qkv_proj.bias"] = torch.cat(biases)
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                out[f"{a}{proj}.kernel"] = _kernel(t[f"{p}self_attn.{proj}.weight"])
        out[f"{a}o_proj.kernel"] = _kernel(t[f"{p}self_attn.o_proj.weight"])
        out.update(extras)
        out[f"{p}input_norm.scale"] = t[p + "input_layernorm.weight"].float()
        out[f"{p}post_attn_norm.scale"] = t[p + "post_attention_layernorm.weight"].float()
        moe = _moe_layer_tensors(t, p)
        if moe is not None:
            rw, *experts = moe
            out[f"{p}mlp.router"] = _kernel(rw)
            for name, ws in zip(("gate", "up", "down"), experts):
                out[f"{p}mlp.{name}"] = torch.stack([w.float().T for w in ws])
        elif fused_projections:
            out[f"{p}mlp.gate_up_proj.kernel"] = torch.cat(
                [_kernel(t[f"{p}mlp.{proj}.weight"]) for proj in ("gate_proj", "up_proj")],
                dim=1)
            out[f"{p}mlp.down_proj.kernel"] = _kernel(t[f"{p}mlp.down_proj.weight"])
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                out[f"{p}mlp.{proj}.kernel"] = _kernel(t[f"{p}mlp.{proj}.weight"])
    return out


def _streamed(tensors: Tensors, num_layers: int, tie_embeddings: bool,
              head_bits: int, dev: torch.device, dense, experts) -> Tensors:
    """The streaming loaders' walk. Each checkpoint tensor moves to ``dev``
    once, in its source dtype, through ``load``, which also transposes a
    torch (out, in) weight into an (in, out) kernel there. ``dense(base,
    kernel)`` and ``experts(base, weights, load)`` (a projection's checkpoint
    tensors, one an expert) return the state dict entries they quantize.
    Biases and norms move to ``dev`` in f32, unquantized."""
    t = _strip_prefix(tensors)

    def load(w: torch.Tensor) -> torch.Tensor:
        return w.to(dev).T.contiguous()

    def f32(w: torch.Tensor) -> torch.Tensor:
        return w.to(dev).float()

    out = {"token_embedding": t["embed_tokens.weight"].to(dev).to(torch.bfloat16),
           "final_norm.scale": f32(t["norm.weight"])}
    if not tie_embeddings and "lm_head.weight" in tensors:
        hw = tensors["lm_head.weight"]            # (vocab, h)
        if head_bits == 8:
            out["lm_head_q"], out["lm_head_scale"] = quantize_kernel_int8(load(hw))
        else:
            out["lm_head"] = load(hw).to(torch.bfloat16)
    for i in range(num_layers):
        p = f"layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out.update(dense(f"{p}attention.{proj}", load(t[f"{p}self_attn.{proj}.weight"])))
        out.update(_layer_extras(t, p, f32))
        out[f"{p}input_norm.scale"] = f32(t[p + "input_layernorm.weight"])
        out[f"{p}post_attn_norm.scale"] = f32(t[p + "post_attention_layernorm.weight"])
        moe = _moe_layer_tensors(t, p)
        if moe is not None:
            rw, *stacks = moe
            out[f"{p}mlp.router"] = load(rw).float()
            for name, ws in zip(("gate", "up", "down"), stacks):
                out.update(experts(f"{p}mlp.{name}", ws, load))
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                out.update(dense(f"{p}mlp.{proj}", load(t[f"{p}mlp.{proj}.weight"])))
    return out


def llama_int8_params_from_hf(tensors: Tensors, num_layers: int, tie_embeddings: bool,
                              head_bits: int = 0, device=None) -> Tensors:
    """HF Llama-layout tensors → int8 state dict, quantized on ``device``
    (CUDA unless given another): each weight moves there once in its source
    dtype and is quantized there per output channel
    (``quantize_kernel_int8``; experts one at a time into their stacks), so
    peak device memory is the model so far plus one layer's source tensors
    and the host holds only the checkpoint's map. ``head_bits`` 8 quantizes
    an untied lm_head too (``lm_head_q``, ``lm_head_scale``); else it is
    stored in bf16, as the embedding is."""
    dev = resolve_device(device)

    def dense(base, w):
        q, s = quantize_kernel_int8(w)
        return {f"{base}.kernel_q": q, f"{base}.scale": s}

    def experts(base, ws, load):
        n_out, k = ws[0].shape
        q = torch.empty((len(ws), k, n_out), dtype=torch.int8, device=dev)
        s = torch.empty((len(ws), n_out), dtype=torch.float32, device=dev)
        for e, w in enumerate(ws):
            q[e], s[e] = quantize_kernel_int8(load(w))
        return {f"{base}_q": q, f"{base}_s": s}

    return _streamed(tensors, num_layers, tie_embeddings, head_bits, dev, dense, experts)


def llama_int4_params_from_hf(tensors: Tensors, num_layers: int, tie_embeddings: bool,
                              int4_group: int = 0, head_bits: int = 0,
                              device=None) -> Tensors:
    """The int4 sibling of ``llama_int8_params_from_hf``: packed two per
    byte with group scales (``quantize_int4_groupwise``; the group from
    ``int4_tiling`` / ``int4_group_for``, as the decoder's shapes take it),
    experts uploaded and quantized one at a time, so a layer's stack in its
    source dtype never sits on the device whole beside its result."""
    dev = resolve_device(device)

    def group(k: int) -> int:
        return int4_tiles(k, int4_group)[1]

    def dense(base, w):
        p, gs = quantize_int4_groupwise(w, group=group(w.shape[0]))
        return {f"{base}.kernel_p": p, f"{base}.gscale": gs}

    def experts(base, ws, load):
        p, gs = quantize_experts_int4((load(w) for w in ws), group(ws[0].shape[1]))
        return {f"{base}_p": p, f"{base}_gs": gs}

    return _streamed(tensors, num_layers, tie_embeddings, head_bits, dev, dense, experts)


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


def quantize_decoder_params(params: Tensors, bits: int = 8, embeddings_bf16: bool = True,
                            int4_group: int = 0, head_bits: int = 0) -> Tensors:
    """Post-load weight-only quantization, computed where each tensor lives.
    int8: every 2-D ``*.kernel`` becomes ``*.kernel_q`` (int8, same (in, out)
    layout) + ``*.scale`` (f32 per-output-channel). int4: ``*.kernel_p``
    (packed (in/2, out)) + ``*.gscale`` (f32 (in/group, out); ``int4_group``
    0 = the default group). MoE layers: each stacked expert tensor
    ``*.mlp.{gate,up,down}`` (E, in, out) becomes, int8, ``*_q`` (int8) +
    ``*_s`` (f32 (E, out), per expert per output channel), or, int4, ``*_p``
    (packed (E, in/2, out)) + ``*_gs`` (f32 (E, in/group, out)), each expert
    quantized as a dense kernel is; the router stays f32. bits 0 leaves the
    kernels as they are (head-only quantization). ``head_bits`` 8 turns the
    lm_head into ``lm_head_q`` (int8 (hidden, vocab)) + ``lm_head_scale``
    (f32 (vocab,)); token_embedding and a float lm_head are stored in bf16."""
    if bits not in (0, 4, 8):
        raise NotImplementedError(f"{bits}-bit quantization is not ported")
    out: Tensors = {}
    for name, w in params.items():
        if not bits:
            pass
        elif name.endswith((".mlp.gate", ".mlp.up", ".mlp.down")) and w.ndim == 3:
            if bits == 4:
                out[f"{name}_p"], out[f"{name}_gs"] = quantize_experts_int4(w, int4_group)
            else:
                out[f"{name}_q"], out[f"{name}_s"] = quantize_experts_int8(w)
            continue
        elif name.endswith(".kernel") and w.ndim == 2:
            base = name[:-len(".kernel")]
            if bits == 4:
                out[f"{base}.kernel_p"], out[f"{base}.gscale"] = \
                    quantize_int4_groupwise(w, group=int4_group or None)
            else:
                out[f"{base}.kernel_q"], out[f"{base}.scale"] = \
                    quantize_kernel_int8(w)
            continue
        if name == "lm_head" and head_bits == 8:
            out["lm_head_q"], out["lm_head_scale"] = quantize_kernel_int8(w)
        elif embeddings_bf16 and name in ("token_embedding", "lm_head"):
            out[name] = w.to(torch.bfloat16)
        else:
            out[name] = w
    return out


def _eos_ids(checkpoint_dir: str) -> list:
    """``eos_token_id`` of the checkpoint's generation_config.json (an int
    or a list); none without the file."""
    path = os.path.join(checkpoint_dir, "generation_config.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        e = json.load(f).get("eos_token_id", [])
    return e if isinstance(e, list) else [e]


def load_local_llm(checkpoint_dir: Optional[str], seed: int = 0, device=None,
                   quantization: str = "none", int4_w4a8: bool = False,
                   int4_group: int = 0, max_seq_len: int = 0,
                   head_quantization: str = "none", mesh=None):
    """The local chat LLM. A checkpoint directory (any of ``FAMILIES``;
    Phi-3's packed tensors split first) loads with the JAX loader's
    settings, in its order: the flash
    prefill when head_dim % 128 == 0, the int8 decode kernel for int8
    weights, ``int4_group``, then W4A8 with 512-row groups, the int8
    lm_head (``head_quantization``) only when the head is untied; int8 and
    int4 weights through the streaming loaders on ``device``, unquantized
    ones through the generic path. The tokenizer and EOS ids come from the
    checkpoint. Without a checkpoint: the tiny deterministic random-init
    model of the JAX package, which ignores the checkpoint settings.

    ``mesh`` (a model axis > 1): the weights load onto the mesh's first
    device as above and are cut into the shards' state dicts one weight at
    a time (``tp_shard_model(consume=True)``), so the whole model and its
    shards are never both resident; the LLM is ``LocalLLM(mesh=mesh)``."""
    if not _is_checkpoint(checkpoint_dir):
        cfg = LlamaConfig.tiny()
        tok = load_tokenizer(None, cfg.vocab_size)
        return LocalLLM(cfg, tok, seed=seed, device=device, mesh=mesh)
    if not sharded_mesh(mesh):
        mesh = None
    dev = (resolve_device(device) if mesh is None
           else canonical(mesh.axis_devices("model")[0]))
    cfg = llama_config_from_hf(checkpoint_dir, quantization, max_seq_len=max_seq_len)
    if cfg.head_dim % 128 == 0:
        cfg = dataclasses.replace(cfg, use_flash=True)
    if quantization == "int8":
        cfg = dataclasses.replace(cfg, quant_kernel=True)
    if quantization == "int4" and int4_group:
        cfg = dataclasses.replace(cfg, int4_group=int4_group)
    if quantization == "int4" and int4_w4a8:
        cfg = dataclasses.replace(cfg, int4_w4a8=True, int4_group=512)
    tensors = load_safetensors(checkpoint_dir)
    if any(k.endswith("self_attn.qkv_proj.weight") for k in tensors):
        # Phi-3's packed projections under the standard names (row views)
        tensors = split_packed_tensors(tensors, cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim)
    if head_quantization == "int8" and not cfg.tie_embeddings:
        cfg = dataclasses.replace(cfg, head_quantization="int8")
    head_bits = 8 if cfg.head_quantization == "int8" else 0
    if quantization == "int8" and not cfg.fused_projections:
        params = llama_int8_params_from_hf(tensors, cfg.num_layers, cfg.tie_embeddings,
                                           head_bits=head_bits, device=dev)
    elif quantization == "int4" and not cfg.fused_projections:
        params = llama_int4_params_from_hf(tensors, cfg.num_layers, cfg.tie_embeddings,
                                           int4_group=cfg.int4_group,
                                           head_bits=head_bits, device=dev)
    else:
        # the generic path (and every fused layout): f32 on the host, then
        # quantized where the weights live
        params = {k: v.to(dev) for k, v in llama_params_from_hf(
            tensors, cfg.num_layers, cfg.tie_embeddings,
            fused_projections=cfg.fused_projections).items()}
        if quantization in ("int8", "int4") or head_bits:
            params = quantize_decoder_params(
                params, bits={"int8": 8, "int4": 4}.get(quantization, 0),
                int4_group=cfg.int4_group, head_bits=head_bits)
    del tensors
    tok = load_tokenizer(checkpoint_dir, cfg.vocab_size)
    if mesh is not None:
        from ragmeup_tpu_torch.parallel.tp import tp_shard_model
        params = tp_shard_model(params, cfg, mesh, consume=True)
    return LocalLLM(cfg, tok, params=params, eos_ids=_eos_ids(checkpoint_dir),
                    device=dev, mesh=mesh)
