"""Flax parameter trees → the port's state dicts.

The JAX package initializes its models from ``jax.random`` when no
checkpoint is given; the port draws from ``torch.Generator``. The two give
different numbers, so holding one package against the other needs the same
weights in both: this module turns a flax tree (nested mappings of array
likes, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) into a state
dict for the port's encoder, cross-encoder or decoder.

The port's modules keep the flax names and layouts, so the conversion is a
flatten with ``layer_{i}`` → ``layers.{i}``: kernels stay ``(in, out)``
(the int8 kernel reads ``kernel_q (k, n)``), int8 stays int8, bf16 stays
bf16. Nothing here imports jax or flax.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ragmeup_tpu_torch.models.cross_encoder import CrossEncoderModel
from ragmeup_tpu_torch.models.encoder import BertConfig, BertEncoder

_LAYER = re.compile(r"^layer_(\d+)$")


def to_tensor(a) -> torch.Tensor:
    """numpy (or array-like) → torch tensor; bfloat16 arrays (ml_dtypes)
    keep their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into the port's state-dict keys."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, val in node.items():
                m = _LAYER.match(str(key))
                walk(val, path + ([f"layers.{m.group(1)}"] if m else [str(key)]))
        else:
            out[".".join(path)] = to_tensor(node)

    walk(params, [])
    return out


def encoder_from_flax(cfg: BertConfig, params: Mapping, device=None
                      ) -> BertEncoder:
    """A BertEncoder holding the flax encoder's weights."""
    model = BertEncoder(cfg, device=device)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def cross_encoder_from_flax(cfg: BertConfig, params: Mapping, device=None
                            ) -> CrossEncoderModel:
    """A CrossEncoderModel holding the flax cross-encoder's weights."""
    model = CrossEncoderModel(cfg, device=device)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
