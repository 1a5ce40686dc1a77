"""The device mesh of the port.

Counterpart of ``ragmeup_tpu/parallel/mesh.py``: one 3-axis mesh
``('data', 'corpus', 'model')`` laid over a list of devices.

- ``data``: query/batch data parallelism;
- ``corpus``: corpus columns shard over it (parallel/sharded_index.py);
- ``model``: tensor parallelism of the decoder (heads and MLP columns;
  the stacked experts of a sparse MoE; the vocabulary when the LLM serves).

One process drives every device of the mesh, as the JAX package's
controller does: the sharded programs run each shard's work on its own
device and merge the small per-shard results on the mesh's first device.
A device may appear more than once (several shards on one card), so the
whole sharded path runs on a single card too. ``mesh.shape`` is a dict by
axis name, as ``jax.sharding.Mesh.shape`` is.

``LOGICAL_RULES`` maps the logical names that each decoder weight carries
(``parallel/tp.py``) onto mesh axes, as the JAX package's flax rules do.
The two collectives of the model axis are ``psum`` (the partial products of
the row-parallel projections and of the expert-parallel combine) and
``all_gather`` (vocabulary-sharded logits, router logits): one process
copies each shard's part to the mesh's first device, reduces or
concatenates there in shard order, and copies the result to each device
that needs it, once per distinct device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.devices import resolve_device

AXES = ("data", "corpus", "model")

# logical axis name -> mesh axis (None = replicated); the JAX package's rules
LOGICAL_RULES = (
    ("batch", "data"),
    ("seq", None),          # sequence dim of params (e.g. position embeddings)
    ("act_seq", "corpus"),  # activation sequence sharding (SP) reuses corpus axis
    ("embed", None),
    ("qkv", "model"),
    ("kv", "model"),
    ("mlp", "model"),
    ("expert", "model"),    # EP: stacked MoE experts shard over 'model'
    ("moe_inter", None),    # per-expert ffn dim stays local under EP
    ("vocab", None),
    ("corpus", "corpus"),
    ("unmodeled", None),
)


def vocab_sharded(rules=LOGICAL_RULES):
    """``rules`` with 'vocab' over 'model' (output-embedding parallelism:
    the embedding and the head shard their vocabulary rows)."""
    return tuple(("vocab", "model") if name == "vocab" else (name, axis)
                 for name, axis in rules)


def logical_axes(names: Sequence[str], rules=LOGICAL_RULES) -> Tuple[Optional[str], ...]:
    """The mesh axis of each logical name (None: replicated)."""
    table = dict(rules)
    return tuple(table[name] for name in names)


def local_size(size: int, name: str, n_model: int, rules=LOGICAL_RULES) -> int:
    """A dim's size on one shard of an ``n_model``-way model axis: divided
    when its logical name maps to 'model' and the axis divides it, else
    whole (an indivisible dim stays replicated, as ``_drop_indivisible``
    keeps it)."""
    if dict(rules)[name] == "model" and size % n_model == 0:
        return size // n_model
    return size


class Mesh:
    """An ndarray of ``torch.device`` laid out over ``AXES``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at their first index."""
        at = [0] * len(self.axis_names)
        at[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(at)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def mesh_shape_for(n_devices: int,
                   model_parallel: Optional[int] = None,
                   corpus_parallel: Optional[int] = None) -> Tuple[int, int, int]:
    """Factor n_devices into (data, corpus, model). Defaults: give the
    corpus axis the largest power-of-two factor, then model, then data."""
    if model_parallel and corpus_parallel:
        assert n_devices % (model_parallel * corpus_parallel) == 0
        return (n_devices // (model_parallel * corpus_parallel),
                corpus_parallel, model_parallel)
    m = model_parallel or 1
    rest = n_devices // m
    assert n_devices % m == 0, f"{n_devices} devices not divisible by model={m}"
    c = corpus_parallel or _largest_pow2_factor(rest)
    assert rest % c == 0
    return (rest // c, c, m)


def _largest_pow2_factor(n: int) -> int:
    p = 1
    while n % (p * 2) == 0:
        p *= 2
    return p


def visible_devices() -> List[torch.device]:
    """Every visible card; raises (``resolve_device``) without one."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build the ('data','corpus','model') mesh over the given devices
    (default: every visible card)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else visible_devices())
    if shape is None:
        shape = mesh_shape_for(len(devices))
    shape = tuple(shape)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), AXES)


# -- collectives over a list of per-shard tensors --------------------------------

def canonical(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def replicate(t: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """``t`` on each of ``devices``: one copy per distinct device (shards
    on one device share it; ``t`` itself where it already lives)."""
    held: Dict[torch.device, torch.Tensor] = {t.device: t}
    out = []
    for dev in devices:
        dev = canonical(dev)
        if dev not in held:
            held[dev] = t.to(dev)
        out.append(held[dev])
    return out


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' partials, on each shard's device. The partials
    are copied to the first shard's device (the mesh's first) and added in
    shard order, ((p0 + p1) + p2) + ..., each addition rounded to the
    partials' dtype as the JAX package's psum of a bf16 product rounds;
    the sum is copied back once per distinct device."""
    first = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(first)
    return replicate(acc, [p.device for p in parts])


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1,
               devices: Optional[Sequence] = None) -> List[torch.Tensor]:
    """The shards' parts concatenated along ``dim`` in shard order on the
    first shard's device, then copied to each of ``devices`` (default: each
    shard's device)."""
    first = parts[0].device
    whole = torch.cat([p.to(first) for p in parts], dim=dim)
    return replicate(whole, [p.device for p in parts] if devices is None else devices)
