"""Write HF-layout checkpoint directories with random weights, torch only.

    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint llama31_8b --out DIR
    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint mixtral_8x7b --out DIR --layers 2
    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint gemma2_9b --out DIR
    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint qwen3_30b_a3b --out DIR --layers 2
    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint gist_small --out DIR
    python3 -m ragmeup_tpu_torch.tools.synthetic_checkpoint minilm_l6_cross --out DIR

Each directory has what a ``save_pretrained`` directory gives the loaders
of ``models/hf_loader.py``: config.json, generation_config.json for the
decoders, and the weights under their HF names in safetensors shards of
about ``--shard-gb`` GB with a ``model.safetensors.index.json`` (one
``model.safetensors`` when the weights fit one shard). Models:

- ``llama31_8b``: Llama-3.1-8B's layout and config (vocab 128256, 4096
  wide, 32 layers, 32/8 heads, 14336, llama3 rope scaling, 131072
  positions, untied lm_head), EOS ids [128001, 128009]; 16.06 GB in four
  shards at full depth.
- ``mixtral_8x7b``: Mixtral-8x7B-v0.1's (vocab 32000, 8 experts, top-2,
  rope theta 1e6, 32768 positions, ``sliding_window`` null); 93 GB at full
  depth, 6.3 GB at two layers.
- ``gemma2_9b``: google/gemma-2-9b's (vocab 256000, 3584 wide, 42 layers,
  16/8 heads of 256, 14336, gelu_pytorch_tanh, softcaps 50/30,
  query_pre_attn_scalar 256, sliding_window 4096, 8192 positions, a tied
  head, four norms a layer); 18.49 GB.
- ``gemma_7b``: google/gemma-7b's (vocab 256000, 3072 wide, 28 layers,
  16/16 heads of 256, 24576, gelu, a tied head); 17.08 GB.
- ``phi3_mini_4k``: microsoft/Phi-3-mini-4k-instruct's (vocab 32064, 3072
  wide, 32 layers, 32/32 heads of 96, 8192, sliding_window 2047, 4096
  positions), with its packed ``qkv_proj`` and ``gate_up_proj``; 7.64 GB.
- ``qwen25_7b``: Qwen/Qwen2.5-7B-Instruct's (vocab 152064, 3584 wide, 28
  layers, 28/4 heads, 18944, q/k/v biases, rope theta 1e6,
  use_sliding_window false); 15.23 GB.
- ``qwen3_30b_a3b``: Qwen/Qwen3-30B-A3B's (vocab 151936, 2048 wide, 48
  layers, 32/4 heads of 128, 128 experts of 768, top-8, q_norm/k_norm; the
  config of scripts/make_synthetic_30b_moe.py); 61.06 GB, 3.75 GB at two
  layers.
- ``gist_small``: a BERT encoder of GIST-small's shape (384 wide, 12
  layers, 12 heads, 1536, vocab 30522), pooler included.
- ``minilm_l6_cross``: a BERT cross-encoder of ms-marco-MiniLM-L-6's shape
  (6 layers of the above) with a one-logit classifier.

Weights and biases are drawn N(0, 0.02) in bf16 tensor by tensor on
``--device`` (the card by default) from a ``torch.Generator`` seeded with
``--seed``; norms are ones (zeros for Gemma, whose norms scale by one plus
the weight, as HF initializes them) and norm biases zeros; each tensor is written as soon as it is
drawn, so host and device hold one tensor at a time. ``--layers`` writes
a model at full width and reduced depth.

Beside the weights goes a ``tokenizer.json`` of the model's family
(``tools/synthetic_tokenizer.py``, built in plain Python from ``--seed``):
Llama-3's byte-level BPE with its 256 specials at 128000-128255 (EOS
128001 and 128009 are ``<|end_of_text|>`` and ``<|eot_id|>``), Qwen2's,
the SentencePiece-style BPE with byte fallback of Mixtral and Phi-3,
Gemma's, and BERT's WordPiece for the two encoders, each at its published
vocabulary, cut where needed so that its ids stay below the config's
vocab_size.
The loaders read it with the port's reader (``models/tokenizer_json.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from ragmeup_tpu_torch.models.safetensors import Lazy, save_safetensors
from ragmeup_tpu_torch.tools.synthetic_tokenizer import write_tokenizer

STD = 0.02
GB = 1e9

LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 131072,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192}}
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768,
    "rope_theta": 1e6, "rms_norm_eps": 1e-5, "sliding_window": None,
    "hidden_act": "silu", "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "bos_token_id": 1, "eos_token_id": 2}
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "max_position_embeddings": 8192,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "attention_bias": False,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "sliding_window": 4096,
    "cache_implementation": "hybrid", "bos_token_id": 2, "eos_token_id": 1,
    "pad_token_id": 0, "torch_dtype": "bfloat16"}
GEMMA_7B = {
    "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
    "vocab_size": 256000, "hidden_size": 3072, "intermediate_size": 24576,
    "num_hidden_layers": 28, "num_attention_heads": 16,
    "num_key_value_heads": 16, "head_dim": 256, "hidden_act": "gelu",
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rope_scaling": None,
    "rms_norm_eps": 1e-6, "attention_bias": False, "bos_token_id": 2,
    "eos_token_id": 1, "pad_token_id": 0, "torch_dtype": "bfloat16"}
PHI3_MINI_4K = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "hidden_act": "silu",
    "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
    "rope_theta": 10000.0, "rope_scaling": None, "rms_norm_eps": 1e-5,
    "sliding_window": 2047, "attention_bias": False, "tie_word_embeddings": False,
    "bos_token_id": 1, "eos_token_id": 32000, "pad_token_id": 32000,
    "torch_dtype": "bfloat16"}
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
    "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "hidden_act": "silu",
    "max_position_embeddings": 32768, "max_window_layers": 28,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "sliding_window": 131072,
    "use_sliding_window": False, "tie_word_embeddings": False,
    "bos_token_id": 151643, "eos_token_id": 151645, "torch_dtype": "bfloat16"}
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "decoder_sparse_step": 1,
    "mlp_only_layers": [], "norm_topk_prob": True,
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
GIST_SMALL = {
    "architectures": ["BertModel"], "model_type": "bert",
    "vocab_size": 30522, "hidden_size": 384, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 1536,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "hidden_act": "gelu", "torch_dtype": "bfloat16"}
MINILM_L6_CROSS = dict(GIST_SMALL, architectures=["BertForSequenceClassification"],
                       num_hidden_layers=6, num_labels=1)

MODELS = {
    "llama31_8b": (LLAMA31_8B, {"eos_token_id": [128001, 128009]}),
    "mixtral_8x7b": (MIXTRAL_8X7B, {"bos_token_id": 1, "eos_token_id": 2}),
    "gemma2_9b": (GEMMA2_9B, {"bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
                              "cache_implementation": "hybrid"}),
    "gemma_7b": (GEMMA_7B, {"bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0}),
    "phi3_mini_4k": (PHI3_MINI_4K, {"bos_token_id": 1, "eos_token_id": [32000, 32001, 32007],
                                    "pad_token_id": 32000}),
    "qwen25_7b": (QWEN25_7B, {"bos_token_id": 151643, "eos_token_id": [151645, 151643],
                              "pad_token_id": 151643}),
    "qwen3_30b_a3b": (QWEN3_30B_A3B, {"eos_token_id": 151645}),
    "gist_small": (GIST_SMALL, None),
    "minilm_l6_cross": (MINILM_L6_CROSS, None),
}

Spec = Tuple[str, Tuple[int, ...], str]  # name, shape, "normal" | "ones" | "zeros"


def decoder_specs(c: dict) -> List[Spec]:
    """The tensors of a Llama-layout decoder in file order, as HF's models
    of its family name them: Qwen2's q/k/v biases, Qwen3's q/k norms,
    Phi-3's packed qkv_proj and gate_up_proj, Gemma-2's four norms a
    layer, Gemma's zero norms, Mixtral's and Qwen3-MoE's experts (Qwen3-MoE
    keeps the layers its sparse step and mlp_only_layers leave dense)."""
    mt = c["model_type"]
    h, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = c.get("head_dim") or h // c["num_attention_heads"]
    nq, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    norm = "zeros" if mt.startswith("gemma") else "ones"
    bias = c.get("attention_bias", mt == "qwen2")
    specs: List[Spec] = [("model.embed_tokens.weight", (v, h), "normal")]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        specs.append((p + "input_layernorm.weight", (h,), norm))
        if mt == "phi3":
            specs.append((a + "qkv_proj.weight", (nq + 2 * kv, h), "normal"))
        else:
            for proj, n in (("q_proj", nq), ("k_proj", kv), ("v_proj", kv)):
                specs.append((f"{a}{proj}.weight", (n, h), "normal"))
                if bias:
                    specs.append((f"{a}{proj}.bias", (n,), "normal"))
        if mt in ("qwen3", "qwen3_moe"):
            specs += [(a + "q_norm.weight", (hd,), norm), (a + "k_norm.weight", (hd,), norm)]
        specs += [(a + "o_proj.weight", (h, nq), "normal"),
                  (p + "post_attention_layernorm.weight", (h,), norm)]
        if mt == "gemma2":
            specs += [(p + "pre_feedforward_layernorm.weight", (h,), norm),
                      (p + "post_feedforward_layernorm.weight", (h,), norm)]
        step = c.get("decoder_sparse_step", 1)
        if c.get("num_local_experts"):
            m = p + "block_sparse_moe."
            specs.append((m + "gate.weight", (c["num_local_experts"], h), "normal"))
            for e in range(c["num_local_experts"]):
                specs += [(f"{m}experts.{e}.w1.weight", (f, h), "normal"),
                          (f"{m}experts.{e}.w2.weight", (h, f), "normal"),
                          (f"{m}experts.{e}.w3.weight", (f, h), "normal")]
        elif (c.get("num_experts") and i not in (c.get("mlp_only_layers") or ())
              and step > 0 and (i + 1) % step == 0):
            fe = c["moe_intermediate_size"]
            m = p + "mlp."
            specs.append((m + "gate.weight", (c["num_experts"], h), "normal"))
            for e in range(c["num_experts"]):
                specs += [(f"{m}experts.{e}.gate_proj.weight", (fe, h), "normal"),
                          (f"{m}experts.{e}.up_proj.weight", (fe, h), "normal"),
                          (f"{m}experts.{e}.down_proj.weight", (h, fe), "normal")]
        elif mt == "phi3":
            specs += [(p + "mlp.gate_up_proj.weight", (2 * f, h), "normal"),
                      (p + "mlp.down_proj.weight", (h, f), "normal")]
        else:
            specs += [(p + "mlp.gate_proj.weight", (f, h), "normal"),
                      (p + "mlp.up_proj.weight", (f, h), "normal"),
                      (p + "mlp.down_proj.weight", (h, f), "normal")]
    specs.append(("model.norm.weight", (h,), norm))
    if not c.get("tie_word_embeddings", mt.startswith("gemma")):
        specs.append(("lm_head.weight", (v, h), "normal"))
    return specs


def bert_specs(c: dict) -> List[Spec]:
    """The tensors of a BERT encoder (with pooler), or of a BERT
    cross-encoder with a one-logit classifier when ``num_labels`` is set."""
    h, f = c["hidden_size"], c["intermediate_size"]
    cross = bool(c.get("num_labels"))
    b = "bert." if cross else ""
    specs: List[Spec] = [
        (f"{b}embeddings.word_embeddings.weight", (c["vocab_size"], h), "normal"),
        (f"{b}embeddings.position_embeddings.weight",
         (c["max_position_embeddings"], h), "normal"),
        (f"{b}embeddings.token_type_embeddings.weight", (c["type_vocab_size"], h), "normal"),
        (f"{b}embeddings.LayerNorm.weight", (h,), "ones"),
        (f"{b}embeddings.LayerNorm.bias", (h,), "zeros")]

    def dense(name, n_out, n_in):
        return [(f"{name}.weight", (n_out, n_in), "normal"), (f"{name}.bias", (n_out,), "normal")]

    def norm(name):
        return [(f"{name}.weight", (h,), "ones"), (f"{name}.bias", (h,), "zeros")]

    for i in range(c["num_hidden_layers"]):
        p = f"{b}encoder.layer.{i}."
        for proj in ("query", "key", "value"):
            specs += dense(f"{p}attention.self.{proj}", h, h)
        specs += dense(f"{p}attention.output.dense", h, h) + norm(f"{p}attention.output.LayerNorm")
        specs += dense(f"{p}intermediate.dense", f, h) + dense(f"{p}output.dense", h, f)
        specs += norm(f"{p}output.LayerNorm")
    specs += dense(f"{b}pooler.dense", h, h)
    if cross:
        specs += dense("classifier", c["num_labels"], h)
    return specs


def _specs(config: dict) -> List[Spec]:
    return bert_specs(config) if config["model_type"] == "bert" else decoder_specs(config)


def _nbytes(shape) -> int:
    n = 2  # bf16
    for d in shape:
        n *= d
    return n


def shards(specs: List[Spec], shard_bytes: float) -> List[List[Spec]]:
    """Consecutive groups of tensors of at most ``shard_bytes`` each (a
    larger tensor alone)."""
    out: List[List[Spec]] = [[]]
    size = 0
    for spec in specs:
        n = _nbytes(spec[1])
        if out[-1] and size + n > shard_bytes:
            out.append([])
            size = 0
        out[-1].append(spec)
        size += n
    return out


def write_checkpoint(out_dir: str, model: str, layers: Optional[int] = None,
                     seed: int = 0, device="cuda", shard_gb: float = 5.0) -> Dict[str, float]:
    """Write ``model``'s directory (``MODELS``) with ``layers`` layers (None:
    all) and its tokenizer.json, its ids below the config's vocab_size;
    returns the weight bytes written and the seconds they took, and the
    tokenizer's tokens, bytes and seconds."""
    config, generation = MODELS[model]
    config = dict(config)
    if layers is not None:
        config["num_hidden_layers"] = int(layers)
    tok = write_tokenizer(out_dir, model, seed=seed, vocab_size=config["vocab_size"])
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if generation is not None:
        with open(os.path.join(out_dir, "generation_config.json"), "w") as f:
            json.dump(generation, f, indent=2)
    specs = _specs(config)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(shape, kind):
        if kind == "ones":
            return lambda: torch.ones(shape, dtype=torch.bfloat16, device=device)
        if kind == "zeros":
            return lambda: torch.zeros(shape, dtype=torch.bfloat16, device=device)
        return lambda: torch.empty(shape, dtype=torch.bfloat16, device=device).normal_(
            0.0, STD, generator=gen)

    groups = shards(specs, shard_gb * GB)
    names = (["model.safetensors"] if len(groups) == 1 else
             [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors" for i in range(len(groups))])
    weight_map, total = {}, 0
    for name, group in zip(names, groups):
        save_safetensors({n: Lazy(shape, torch.bfloat16, make(shape, kind))
                          for n, shape, kind in group},
                         os.path.join(out_dir, name), metadata={"format": "pt"})
        for n, shape, _ in group:
            weight_map[n] = name
            total += _nbytes(shape)
    if len(groups) > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                      indent=2)
    return {"bytes": float(total), "seconds": time.perf_counter() - t0,
            **{f"tokenizer_{k}": v for k, v in tok.items()}}


def checkpoint_bytes(model: str, layers: Optional[int] = None) -> float:
    """The weight bytes ``write_checkpoint`` writes for ``model`` with
    ``layers`` layers (None: all)."""
    config = dict(MODELS[model][0])
    if layers is not None:
        config["num_hidden_layers"] = int(layers)
    return float(sum(_nbytes(shape) for _, shape, _ in _specs(config)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=sorted(MODELS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder or encoder layers (default: the model's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shard-gb", type=float, default=5.0)
    args = ap.parse_args()
    r = write_checkpoint(args.out, args.model, args.layers, args.seed, args.device,
                         args.shard_gb)
    print(json.dumps({"out": args.out, "model": args.model, "GB": r["bytes"] / GB,
                      "seconds": r["seconds"], "GBps": r["bytes"] / GB / r["seconds"],
                      "tokenizer_seconds": r["tokenizer_seconds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
