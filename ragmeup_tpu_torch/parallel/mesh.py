"""The device mesh of the port.

Counterpart of ``ragmeup_tpu/parallel/mesh.py``: one 3-axis mesh
``('data', 'corpus', 'model')`` laid over a list of devices.

- ``data``: query/batch data parallelism;
- ``corpus``: corpus columns shard over it (parallel/sharded_index.py);
- ``model``: tensor parallelism of the decoder.

One process drives every device of the mesh, as the JAX package's
controller does: the sharded programs run each shard's work on its own
device and merge the small per-shard results on the mesh's first device.
A device may appear more than once (several shards on one card), so the
whole sharded path runs on a single card too. ``mesh.shape`` is a dict by
axis name, as ``jax.sharding.Mesh.shape`` is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.devices import resolve_device

AXES = ("data", "corpus", "model")


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
