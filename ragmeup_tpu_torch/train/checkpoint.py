"""Checkpoint / resume for training state and model params.

Counterpart of ``ragmeup_tpu/train/checkpoint.py``, which writes with
orbax; the port writes its own files. A train state's checkpoint is a
``step_N`` directory holding

- ``params.safetensors``: the parameters, one tensor a weight
  (``models/safetensors.py``). A model-axis state's shards are put back
  together first (``parallel/tp.py``'s ``unshard_param``, one weight at a
  time), so a checkpoint written under TP restores on one device and back;
- ``train_state.pt`` (``torch.save``): the step, the optimizer's
  hyperparameters and its per-parameter state keyed by weight, each moment
  put back together as its parameter is.

``restore_train_state`` lays a checkpoint out as a template state is laid
out (its devices, its model axis), and a step function copies it into its
model (``train.TrainState``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from ragmeup_tpu_torch.models.safetensors import Lazy, load_safetensors, save_safetensors
from ragmeup_tpu_torch.parallel.mesh import canonical
from ragmeup_tpu_torch.parallel.tp import model_param_shardings, shard_param, unshard_param
from ragmeup_tpu_torch.train.train import ShardedParams, TrainState

PARAMS_FILE = "params.safetensors"
STATE_FILE = "train_state.pt"


def _specs(params: ShardedParams) -> Dict[str, tuple]:
    return model_param_shardings(params.cfg, params.mesh, shard_vocab=True)


def _whole(params) -> Mapping[str, Any]:
    """One tensor a weight: a one-device state dict as it is, a model-axis
    state's weights put back together when each is written (``Lazy``)."""
    if not isinstance(params, ShardedParams):
        return params
    specs = _specs(params)
    out = {}
    for key, spec in specs.items():
        parts = [shard[key].detach() for shard in params]
        shape = list(parts[0].shape)
        if "model" in spec:
            shape[spec.index("model")] *= len(parts)
        out[key] = Lazy(tuple(shape), parts[0].dtype,
                        lambda key=key, parts=parts, spec=spec:
                        unshard_param(key, parts, spec, params.cfg))
    return out


def _whole_opt_state(params, opt_state: Mapping) -> Dict[str, Any]:
    """The optimizer's state keyed by weight, a model-axis state's moments
    (tensors of a shard's parameter shape) put back together."""
    if not isinstance(params, ShardedParams):
        return {"param_groups": opt_state["param_groups"],
                "state": {k: {n: (v.detach() if isinstance(v, torch.Tensor) else v)
                              for n, v in e.items()} for k, e in opt_state["state"].items()}}
    specs = _specs(params)
    keyed = opt_state["state"]
    state = {}
    for key, entry in keyed[0].items():
        whole = {}
        for name, v in entry.items():
            parts = [shard[key][name] for shard in keyed]
            if isinstance(v, torch.Tensor) and v.shape == params[0][key].shape:
                whole[name] = unshard_param(key, [p.detach() for p in parts], specs[key],
                                            params.cfg)
            else:
                whole[name] = v.detach() if isinstance(v, torch.Tensor) else v
        state[key] = whole
    return {"param_groups": opt_state["param_groups"], "state": state}


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save a TrainState under ``directory/step_N``; returns that path."""
    step = int(state.step) if step is None else step
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    save_safetensors(_whole(state.params), os.path.join(path, PARAMS_FILE))
    body = _whole_opt_state(state.params, state.opt_state)
    body["step"] = int(state.step)
    torch.save(body, os.path.join(path, STATE_FILE))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``step_N`` directory with the largest N, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(os.path.abspath(directory), max(steps)[1])


def _lay_out(whole: Mapping[str, torch.Tensor], template):
    """Whole weights (CPU) laid out as ``template`` is: each on its
    template tensor's device and dtype, or cut over the template's model
    axis (``ShardedParams``)."""
    if not isinstance(template, ShardedParams):
        return {k: whole[k].to(device=t.device, dtype=t.dtype) for k, t in template.items()}
    specs = _specs(template)
    devices = [canonical(d) for d in template.mesh.axis_devices("model")]
    shards = [{} for _ in template]
    for key, spec in specs.items():
        t = whole[key].to(template[0][key].dtype)
        for i, part in enumerate(shard_param(key, t, spec, template.cfg, devices)):
            shards[i][key] = part
    return ShardedParams(shards, template.cfg, template.mesh)


def restore_train_state(path: str, state_template: TrainState) -> TrainState:
    """Restore a ``step_N`` directory into the layout of ``state_template``
    (a fresh step function's state): its devices, dtypes and model axis."""
    whole = load_safetensors(os.path.join(path, PARAMS_FILE))
    params = _lay_out(whole, state_template.params)
    body = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    return TrainState(step=int(body["step"]), params=params,
                      opt_state={"param_groups": body["param_groups"],
                                 "state": _lay_out_state(body["state"], whole, params)})


def _lay_out_state(state: Mapping, whole: Mapping[str, torch.Tensor], params) -> Any:
    """The optimizer's state keyed by weight, laid out as ``params``: a
    moment (a tensor of its whole weight's shape) as its weight is, the
    rest (step counts) as they are."""
    def moment(key, v):
        return isinstance(v, torch.Tensor) and v.shape == whole[key].shape

    if not isinstance(params, ShardedParams):
        return {key: {name: v.to(params[key].device) if moment(key, v) else v
                      for name, v in entry.items()}
                for key, entry in state.items()}
    specs = _specs(params)
    devices = [canonical(d) for d in params.mesh.axis_devices("model")]
    shards = [{key: {} for key in state} for _ in params]
    for key, entry in state.items():
        for name, v in entry.items():
            parts = (shard_param(key, v, specs[key], params.cfg, devices) if moment(key, v)
                     else [v] * len(params))
            for i, part in enumerate(parts):
                shards[i][key][name] = part
    return shards


def save_params(directory: str, params: Any, name: str = "params") -> str:
    """Save bare parameters (a state dict, or ``ShardedParams`` put back
    together) to ``directory/<name>.safetensors``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), f"{name}.safetensors")
    save_safetensors(_whole(params), path)
    return path


def restore_params(path: str, template: Optional[Any] = None) -> Any:
    """Parameters saved by ``save_params``: CPU tensors on a map of the
    file, or laid out as ``template`` (a state dict or ``ShardedParams``)."""
    whole = load_safetensors(path)
    return whole if template is None else _lay_out(whole, template)
