"""Tensor-parallel inference: where each decoder weight lives on the model axis.

Counterpart of ``ragmeup_tpu/parallel/tp.py``. The JAX package reads each
flax param's logical partitioning names and lets GSPMD place the tree; the
port keeps a table from each key of the decoder's state dict to the same
names (``param_logical_names``), maps them onto the mesh with the same
rules (``parallel/mesh.py``'s ``LOGICAL_RULES``; ``shard_vocab`` puts the
vocabulary over 'model' as serving does), replicates any dim the axis does
not divide (``_drop_indivisible``), and cuts a state dict into one state
dict a shard (``tp_shard_model``), each shard's tensors contiguous on its
own device, for ``models/decoder.py``'s ``ShardedLlamaModel``.
``tp_gather_model`` puts the shards back together into one state dict (a
checkpoint written under the model axis restores on one device).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ragmeup_tpu_torch.models.convert import flax_to_state_dict
from ragmeup_tpu_torch.models.decoder import LlamaConfig, LlamaModel
from ragmeup_tpu_torch.ops.quant_matmul import int4_tiling, pack_int4, unpack_int4
from ragmeup_tpu_torch.parallel.mesh import (LOGICAL_RULES, canonical, logical_axes,
                                             replicate, vocab_sharded)

Spec = Tuple[Optional[str], ...]

# QuantDense layers by module name: the logical names of (in, out)
_DENSE = {"q_proj": ("embed", "qkv"), "k_proj": ("embed", "kv"),
          "v_proj": ("embed", "kv"), "qkv_proj": ("embed", "qkv"),
          "o_proj": ("qkv", "embed"), "gate_proj": ("embed", "mlp"),
          "up_proj": ("embed", "mlp"), "gate_up_proj": ("embed", "mlp"),
          "down_proj": ("mlp", "embed")}
_UP = ("expert", "embed", "moe_inter")
_DOWN = ("expert", "moe_inter", "embed")
# LlamaMoeMlp's tensors by name
_EXPERTS = {"router": ("embed", "expert"),
            "gate": _UP, "up": _UP, "down": _DOWN,
            "gate_q": _UP, "up_q": _UP, "down_q": _DOWN,
            "gate_s": ("expert", "moe_inter"), "up_s": ("expert", "moe_inter"),
            "down_s": ("expert", "embed"),
            "gate_p": _UP, "up_p": _UP, "down_p": _DOWN,
            "gate_gs": _UP, "up_gs": _UP, "down_gs": _DOWN}
_TOP = {"token_embedding": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
        "lm_head_q": ("embed", "vocab"), "lm_head_scale": ("vocab",)}


def logical_names(key: str) -> Tuple[str, ...]:
    """The logical names that the flax param behind state-dict ``key``
    carries in the JAX decoder (``nn.with_logical_partitioning``)."""
    if key in _TOP:
        return _TOP[key]
    *path, leaf = key.split(".")
    owner = path[-1] if path else ""
    if owner.endswith("norm") and leaf == "scale":
        return ("embed",)
    if owner in _DENSE:
        names = _DENSE[owner]
        return (names[1],) if leaf in ("scale", "bias") else names
    if owner == "mlp" and leaf in _EXPERTS:
        return _EXPERTS[leaf]
    raise KeyError(f"no logical names for decoder weight {key!r}")


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict key of the one-device decoder with its shape."""
    with torch.device("meta"):
        model = LlamaModel(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def param_logical_names(cfg: LlamaConfig) -> Dict[str, Tuple[str, ...]]:
    """State-dict key → logical names, for every weight of ``cfg``'s decoder."""
    return {k: logical_names(k) for k in param_shapes(cfg)}


def model_param_shardings(cfg: LlamaConfig, mesh, shard_vocab: bool = False
                          ) -> Dict[str, Spec]:
    """State-dict key → the mesh axis of each dim (None: replicated), from
    the logical names by ``LOGICAL_RULES``; ``shard_vocab`` also shards the
    'vocab' names over 'model' (the embedding's rows and the head's
    columns, 1/D each: the serving LLM's setting). A dim the axis does not
    divide stays replicated (``_drop_indivisible``)."""
    rules = vocab_sharded(LOGICAL_RULES) if shard_vocab else LOGICAL_RULES
    shapes = param_shapes(cfg)
    specs = {k: logical_axes(logical_names(k), rules) for k in shapes}
    return _drop_indivisible(shapes, specs, mesh)


def _drop_indivisible(shapes: Mapping[str, Tuple[int, ...]], specs: Mapping[str, Spec],
                      mesh) -> Dict[str, Spec]:
    """Replicate any dim whose size its mesh axis does not divide (e.g. an
    int4 group scale with k // group == 1 rows on a 4-way 'model' axis):
    a small tensor is cheaper replicated than padded."""
    return {k: tuple(ax if ax is None or shapes[k][i] % mesh.shape[ax] == 0 else None
                     for i, ax in enumerate(spec))
            for k, spec in specs.items()}


def _sections(key: str, cfg: LlamaConfig) -> Optional[List[int]]:
    """The column sections of a fused projection: each shard takes its
    share of every section, so its local output splits as on one device."""
    owner = key.split(".")[-2] if "." in key else ""
    if owner == "qkv_proj":
        hd = cfg.head_dim
        return [cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd]
    if owner == "gate_up_proj":
        return [cfg.intermediate_size] * 2
    return None


def _shard_of(key: str, t: torch.Tensor, dim: int, i: int, n: int,
              cfg: LlamaConfig) -> torch.Tensor:
    """Shard i of n of ``t`` along ``dim`` (a view, or a new tensor)."""
    sections = _sections(key, cfg)
    if sections is not None:
        return torch.cat([sec.narrow(dim, i * (sec.shape[dim] // n), sec.shape[dim] // n)
                          for sec in t.split(sections, dim=dim)], dim=dim)
    if key.endswith("kernel_p") and t.dim() == 2 and dim == 0:
        # a row shard of a packed int4 kernel: the byte slice when whole
        # packing tiles fall to each shard, else its rows packed anew
        k = 2 * t.shape[0]
        k_l = k // n
        tile = int4_tiling(k)[0]
        if k_l % tile == 0:
            return t.narrow(0, i * k_l // 2, k_l // 2)
        return pack_int4(unpack_int4(t, tile).narrow(0, i * k_l, k_l), int4_tiling(k_l)[0])
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def shard_param(key: str, t: torch.Tensor, spec: Spec, cfg: LlamaConfig, devices
                ) -> List[torch.Tensor]:
    """Weight ``key`` (or a tensor of its shape, such as an optimizer's
    moment) cut by its ``spec`` into one tensor a shard of ``devices``: a
    sharded one a new contiguous tensor on the shard's device, a replicated
    one held once per distinct device."""
    if "model" not in spec:
        return replicate(t, devices)
    dim = spec.index("model")
    n = len(devices)
    out = []
    for i in range(n):
        piece = _shard_of(key, t, dim, i, n, cfg)
        out.append(torch.empty(piece.shape, dtype=piece.dtype,
                               device=devices[i]).copy_(piece))
    return out


def unshard_param(key: str, parts: Sequence[torch.Tensor], spec: Spec, cfg: LlamaConfig,
                  device=None) -> torch.Tensor:
    """The inverse of ``shard_param`` for float weights (a train state's):
    the shards' parts of ``key`` as one tensor on ``device`` (default: the
    first part's), a fused projection's sections put back as they were
    cut."""
    device = parts[0].device if device is None else device
    if "model" not in spec:
        return parts[0].to(device)
    dim = spec.index("model")
    parts = [p.to(device) for p in parts]
    n = len(parts)
    sections = _sections(key, cfg)
    if sections is not None:
        pieces = [p.split([sec // n for sec in sections], dim=dim) for p in parts]
        return torch.cat([torch.cat([pc[j] for pc in pieces], dim=dim)
                          for j in range(len(sections))], dim=dim)
    if key.endswith("kernel_p") and dim == 0:
        raise ValueError(f"{key}: a packed int4 row shard is not put back together")
    return torch.cat(parts, dim=dim)


def tp_gather_model(shards: Sequence[Mapping[str, torch.Tensor]], cfg: LlamaConfig, mesh,
                    device=None) -> Dict[str, torch.Tensor]:
    """One state dict from the shards' (``tp_shard_model``'s inverse), on
    ``device`` (default: the first shard's device)."""
    specs = model_param_shardings(cfg, mesh, shard_vocab=True)
    return {key: unshard_param(key, [s[key] for s in shards], spec, cfg, device)
            for key, spec in specs.items()}


def tp_shard_model(params: Mapping, cfg: LlamaConfig, mesh,
                   consume: bool = False) -> List[Dict[str, torch.Tensor]]:
    """One state dict a shard of the mesh's model axis, from the decoder's
    state dict (or a flax tree, through ``convert.flax_to_state_dict``),
    the vocabulary sharded as the serving LLM shards it.

    A sharded tensor's shard is a new contiguous tensor on the shard's
    device (the kernels read row-major local matrices, so no shard is a
    view); a replicated one is held once per distinct device, shared by the
    shards on it. ``consume`` pops each weight from ``params`` once it is
    cut, so the whole model and its shards do not both stay resident."""
    if any(isinstance(v, Mapping) for v in params.values()):
        params, consume = flax_to_state_dict(params), True
    specs = model_param_shardings(cfg, mesh, shard_vocab=True)
    if set(specs) != set(params):
        raise KeyError(f"state dict and decoder differ: missing "
                       f"{sorted(set(specs) - set(params))[:4]}, unexpected "
                       f"{sorted(set(params) - set(specs))[:4]}")
    devs = [canonical(d) for d in mesh.axis_devices("model")]
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devs]
    for key, spec in specs.items():
        t = params.pop(key) if consume else params[key]
        for i, ti in enumerate(shard_param(key, t, spec, cfg, devs)):
            out[i][key] = ti
        del t
    return out
