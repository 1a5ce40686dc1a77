"""Multi-process (multi-slice) runtime on ``torch.distributed``.

Counterpart of ``ragmeup_tpu/parallel/dcn.py``. The JAX package joins N
processes (one a slice or host) into one JAX runtime whose mesh spans every
slice's chips, and XLA drives the collectives from the shardings. Here each
process drives its own devices with the port's one-process mesh, and the
processes meet in ``torch.distributed``: gloo on the CPU, nccl where every
rank has a card. The address is explicit (``tcp://host:port``); nothing
detects a cluster.

Axis layout rule (the scaling-book recipe, as in the JAX package): the axis
that crosses processes must be the one with the lightest collectives,
``data`` (a gradient all-reduce once a step) or ``corpus`` (one small
(score, id) all-gather a query wave). ``model`` (activations every layer)
stays inside a process. ``make_multislice_mesh`` gives this rank its block
of the global mesh: the slice dimension is outermost on the slice axis.

- a corpus axis across ranks: each rank scores its part of the corpus over
  its own corpus devices (``parallel/sharded_index.py``), then
  ``merge_topk`` all-gathers the (score, id) candidates and keeps the
  (-score, id) order of ``ops/topk.py``'s ``merge_sorted``;
- a data axis across ranks: each rank takes its rows of the global batch
  (``global_batch``) and ``train/train.py``'s decoder step all-reduces the
  gradients and the loss's global counts (``all_sum``).

``ragmeup_tpu_torch/tools/dcn_dryrun.py`` runs both in two CPU processes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh

_LOCAL: Dict[str, object] = {}


def initialize_slice(coordinator: str, num_processes: int, process_id: int,
                     local_device_count: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process to the multi-process runtime at ``coordinator``
    (``tcp://host:port`` or ``host:port``) as rank ``process_id`` of
    ``num_processes``.

    ``local_device_count`` makes this rank a CPU rank of that many devices
    (``"cpu"`` repeated, as the port's mesh allows); without it a rank with
    a card drives ``cuda:(process_id % cards)``, one without raises. The
    backend is gloo for CPU ranks and nccl for card ranks unless given."""
    if local_device_count is not None:
        devices = ["cpu"] * local_device_count
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a rank without a card needs "
                               "local_device_count (a CPU rank)")
        devices = [torch.device("cuda", process_id % torch.cuda.device_count())]
    if backend is None:
        backend = "gloo" if local_device_count is not None else "nccl"
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    torch.distributed.init_process_group(backend, init_method=init,
                                         world_size=num_processes, rank=process_id)
    _LOCAL.update(devices=devices, backend=backend)


def local_devices() -> list:
    """This rank's devices (``initialize_slice``)."""
    if "devices" not in _LOCAL:
        raise RuntimeError("initialize_slice has not run in this process")
    return list(_LOCAL["devices"])


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank (a new tensor, on ``t``'s device; gloo
    ranks on the CPU, nccl ranks on their card)."""
    out = t.detach().clone().contiguous()
    torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.SUM)
    return out


def all_gather_cat(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along
    ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t)
    return torch.cat(parts, dim=dim)


class SliceMesh(Mesh):
    """This rank's block of a global mesh that spans ``num_slices``
    processes along ``slice_axis``: its own devices laid over ``AXES``,
    with the global shape beside them."""

    def __init__(self, devices: np.ndarray, slice_axis: str, num_slices: int,
                 slice_index: int):
        super().__init__(devices, AXES)
        self.slice_axis = slice_axis
        self.num_slices = num_slices
        self.slice_index = slice_index

    @property
    def global_shape(self) -> Dict[str, int]:
        shape = dict(self.shape)
        shape[self.slice_axis] *= self.num_slices
        return shape


def make_multislice_mesh(slice_axis: str = "data", model_parallel: int = 1) -> SliceMesh:
    """This rank's block of the global ('data', 'corpus', 'model') mesh.

    The slice boundary is the outermost dimension of ``slice_axis`` ('data'
    or 'corpus'); ``model`` never crosses processes. Each rank's devices
    factor as (1, per_slice / model_parallel, model_parallel): globally the
    data axis has one index a rank (``slice_axis="data"``), or the corpus
    axis holds each rank's corpus shards in rank order ("corpus")."""
    if slice_axis not in ("data", "corpus"):
        raise ValueError("slice axis must be 'data' or 'corpus' (TP over "
                         "DCN would put per-layer activations on the slow "
                         "network)")
    devices = local_devices()
    per_slice = len(devices)
    if per_slice % model_parallel != 0:
        raise ValueError(f"{per_slice} devices/slice not divisible by "
                         f"model={model_parallel}")
    local = make_mesh((1, per_slice // model_parallel, model_parallel), devices=devices)
    return SliceMesh(local.devices, slice_axis, torch.distributed.get_world_size(),
                     torch.distributed.get_rank())


def _rank_part(arr: np.ndarray, dim: int, mesh: SliceMesh) -> np.ndarray:
    n = arr.shape[dim]
    if n % mesh.num_slices:
        raise ValueError(f"dim {dim} of {n} over {mesh.num_slices} slices")
    per = n // mesh.num_slices
    return np.take(arr, np.arange(mesh.slice_index * per, (mesh.slice_index + 1) * per),
                   axis=dim)


def global_batch(mesh: SliceMesh, host_arrays: Mapping, spec: Sequence[Optional[str]]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's part of per-process identical host arrays: along the dim
    that ``spec`` (a mesh axis or None a dim, as a PartitionSpec) puts on
    the slice axis, the rank's ``1 / num_slices`` (CPU tensors)."""
    out = {}
    for name, arr in host_arrays.items():
        arr = np.asarray(arr)
        for dim, axis in enumerate(spec):
            if axis == mesh.slice_axis:
                arr = _rank_part(arr, dim, mesh)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def replicated(mesh: SliceMesh, arr) -> torch.Tensor:
    """Identical per-process data, whole on every rank (a CPU tensor)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k from each rank's (b, k_r) candidates (scores, global
    ids): all-gathered along the candidates, ordered by (-score, id) as
    ``ops/topk.py``'s ``merge_sorted`` orders them, k kept. The gather runs
    on the backend's device (the CPU for gloo); the result comes back to
    ``scores``' device."""
    from ragmeup_tpu_torch.ops.topk import merge_sorted
    dev = scores.device
    wire = torch.device("cpu") if _LOCAL.get("backend") == "gloo" else dev
    s = all_gather_cat(scores.float().to(wire), dim=1)
    i = all_gather_cat(ids.long().to(wire), dim=1)
    s, i = merge_sorted(s, i, k)
    return s.to(dev), i.to(dev)


def sharded_topk_across(mesh: SliceMesh, queries, corpus_t_part: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over a corpus whose columns span the ranks
    (``slice_axis="corpus"``): ``corpus_t_part`` (d, N / ranks) is this
    rank's part (``global_batch`` with spec (None, 'corpus')), scored over
    its corpus devices by ``sharded_topk``; its ids are offset to global
    columns and the ranks' candidates merged (``merge_topk``)."""
    from ragmeup_tpu_torch.parallel.sharded_index import sharded_topk
    if mesh.slice_axis != "corpus":
        raise ValueError("the corpus spans ranks only on a slice mesh over 'corpus'")
    s, i = sharded_topk(mesh, queries, corpus_t_part, k)
    offset = mesh.slice_index * corpus_t_part.shape[1]
    i = torch.where(i >= 0, i.long() + offset, i.long())
    return merge_topk(s, i, k)
