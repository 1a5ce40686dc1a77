"""Training: fine-tune the port's decoder (causal LM) and sentence encoder
(contrastive, in-batch negatives) on the user's corpus.

Counterpart of ``ragmeup_tpu/train/train.py``. A step over the
``('data', 'corpus', 'model')`` mesh of ``parallel/mesh.py``:

- **dp**: the batch's rows split over 'data' (its row count a multiple of
  the axis). One process drives the mesh and every data shard holds the
  same weights, so the whole batch goes through one forward on the model
  that the devices at data index 0 hold: the gradient JAX's psum sums over
  the shards, the loss divided by the global mask count. The devices at
  data index > 0 take no work. Across processes (``parallel/dcn.py``, the
  slice axis on 'data') each rank runs its own rows and the gradients are
  all-reduced.
- **tp**: the decoder's weights cut over 'model' by the TP rules
  (``parallel/tp.py``: heads and MLP columns, MoE experts, and the
  vocabulary as serving cuts it), run by a trainable ``ShardedLlamaModel``.
  A replicated weight is one parameter a shard: the copies' gradients are
  summed into the first copy, which the optimizer steps, and the others
  take its value after each step.
- **sp**: JAX constrains the logits to lie sequence-sharded over 'corpus'
  for the loss. One process has no counterpart: the whole logits land on
  the first device, and no ring runs in training.
- **ep**: MoE experts over 'model'; MoE training adds the router
  load-balancing loss (``moe_load_balancing_loss``) at ``router_aux_coef``.

The decoder trains float weights (``quantization="none"``, stored f32,
computed in the config's dtype) through the einsum attention with
``causal_bias``, as JAX's step does. The flash (#8) and int8 (#3) kernels
have no backward, so ``kernels.require_cuda`` refuses to launch them where
a gradient would pass through. Sparse-MoE layers under ``moe_grouped="on"``
(and the dedup route) reach the grouped kernels #11/#12 through
``ops/moe_matmul.GroupedKernelPath``, which carries the JAX package's
backward.

The default optimizer is ``torch.optim.AdamW(lr, betas=(0.9, 0.999),
eps=1e-8, weight_decay=1e-4)`` over one parameter group: optax's ``adamw``
defaults, decay on every parameter (torch's own default decay is 0.01).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.models.convert import flax_to_state_dict
from ragmeup_tpu_torch.models.decoder import (LlamaConfig, LlamaModel, ShardedLlamaModel,
                                              causal_bias, init_decoder_params,
                                              rope_inv_freq)
from ragmeup_tpu_torch.models.encoder import BertConfig, BertEncoder, mean_pool
from ragmeup_tpu_torch.parallel.dcn import SliceMesh, all_sum
from ragmeup_tpu_torch.parallel.mesh import canonical
from ragmeup_tpu_torch.parallel.tp import model_param_shardings, tp_shard_model


class ShardedParams(list):
    """The shards' state dicts of a model-axis state, with the decoder
    config and the mesh they were cut for: what ``train/checkpoint.py``
    needs to put them back together (``parallel/tp.py``'s
    ``unshard_param``)."""

    def __init__(self, shards, cfg: LlamaConfig, mesh):
        super().__init__(shards)
        self.cfg = cfg
        self.mesh = mesh


@dataclasses.dataclass
class TrainState:
    """``step``; ``params``: the state dict of the model's parameters (one
    device), or ``ShardedParams``, one state dict a shard of the model
    axis; ``opt_state``:
    ``{"param_groups": the optimizer's hyperparameters, "state": its
    per-parameter state keyed as params}``.

    A step function owns one model and updates its tensors in place: the
    state it returns holds that model's live tensors, and the state passed
    in is consumed, as JAX's donated state is. A state that a step function
    did not return last (a restored checkpoint, another run's state) is
    copied into its model first."""
    step: int
    params: Any
    opt_state: Any

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


# -- losses -----------------------------------------------------------------------

def _masked_nll(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked next-token NLL, the mask count) in f32."""
    targets = ids[:, 1:].long()
    lg = logits[:, :-1].float()
    m = mask[:, 1:].float()
    logp = F.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.sum(nll * m), torch.sum(m)


def decoder_loss(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy. logits (b, s, v); ids/mask (b, s)."""
    nll, count = _masked_nll(logits, ids, mask)
    return nll / torch.clamp_min(count, 1.0)


def moe_load_balancing_loss(records: Mapping, num_experts: int,
                            all_sum: Optional[Callable] = None) -> torch.Tensor:
    """Switch-Transformer load-balancing loss over every MoE layer's router
    state (``records``: ``router_probs`` (t, E) and ``router_topi`` (t, k)
    lists, a layer each, as ``LlamaModel.forward(router_records=)``
    collects them): ``E * Σ_e f_e · P_e`` per layer, averaged over layers,
    where f_e is the fraction of (token, slot) assignments routed to expert
    e and P_e the mean router probability for e. 1.0 at uniform routing, 0
    when there is no MoE layer.

    ``all_sum`` sums a tensor over the processes of a multi-process step
    (``parallel/dcn.py``): the counts are then global and the result is this
    process's share, whose sum over the processes is the loss."""
    probs = list(records.get("router_probs", ()))
    topis = list(records.get("router_topi", ()))
    if not probs:
        return torch.zeros((), dtype=torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=probs[0].device)
    for p, ti in zip(probs, topis):
        p = p.reshape(-1, num_experts).float()
        counts = (ti.reshape(-1, 1) == torch.arange(num_experts, device=ti.device)
                  ).float().sum(dim=0)
        sizes = torch.tensor([ti.numel(), p.shape[0]], dtype=torch.float32,
                             device=p.device)
        if all_sum is not None:
            counts, sizes = all_sum(counts), all_sum(sizes)
        frac = counts / sizes[0]
        total = total + num_experts * torch.sum(frac * (p.sum(dim=0) / sizes[1]))
    return total / len(probs)


def contrastive_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                     temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE with in-batch negatives: q_emb/d_emb (b, dim), row i of q
    matches row i of d."""
    q = q_emb / torch.clamp_min(torch.linalg.norm(q_emb, dim=-1, keepdim=True), 1e-9)
    d = d_emb / torch.clamp_min(torch.linalg.norm(d_emb, dim=-1, keepdim=True), 1e-9)
    sims = (q @ d.T) / temperature
    logp = F.log_softmax(sims, dim=-1)
    return -torch.mean(torch.diagonal(logp))


# -- parameters -------------------------------------------------------------------

def param_shardings(cfg: LlamaConfig, mesh) -> Dict[str, tuple]:
    """State-dict key → the mesh axis of each dim of the decoder's weights:
    ``parallel/tp.py``'s rules, the vocabulary over 'model' as the port's
    sharded decoder holds it (JAX keeps it replicated in training; the
    numbers are the same)."""
    return model_param_shardings(cfg, mesh, shard_vocab=True)


def _float32(params: Mapping, device, copy: bool = True) -> Dict[str, torch.Tensor]:
    """A state dict (or a flax tree) on ``device``, floating weights in f32;
    with ``copy`` none of the caller's tensors is held (a train step updates
    its weights in place)."""
    if any(isinstance(v, Mapping) for v in params.values()):
        params = flax_to_state_dict(params)
    return {k: (v.float() if v.is_floating_point() else v).to(device, copy=copy)
            for k, v in params.items()}


def init_sharded_params(cfg: LlamaConfig, mesh, seed: int,
                        params: Optional[Mapping] = None):
    """(weights, shardings): ``params`` (a state dict or flax tree), else
    ``init_decoder_params`` drawn from a ``torch.Generator(seed)`` on the
    model axis's first device, in f32; cut into one state dict a shard
    (``tp_shard_model``) when the model axis has more than one shard."""
    first = canonical(mesh.axis_devices("model")[0])
    drawn = params is None
    if drawn:
        gen = torch.Generator(device=first).manual_seed(seed)
        params = init_decoder_params(cfg, gen, first)
    params = _float32(params, first, copy=not drawn)
    if mesh.shape["model"] > 1:
        params = tp_shard_model(params, cfg, mesh, consume=True)
    return params, param_shardings(cfg, mesh)


def _default_optimizer(learning_rate: float) -> Callable:
    def make(parameters):
        return torch.optim.AdamW(parameters, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    return make


class _Trainer:
    """A model's parameters, the optimizer over its distinct weights and
    the conversion between them and a ``TrainState``.

    ``layout`` is one {key: parameter} dict (one device) or one a shard;
    ``specs`` marks the keys that the model axis replicates: each shard
    holds a copy, the first is the one the optimizer steps."""

    def __init__(self, layout, specs: Optional[Mapping], optimizer: Callable,
                 cfg: Optional[LlamaConfig] = None, mesh=None):
        self.cfg, self.mesh = cfg, mesh
        self.sharded = isinstance(layout, list)
        self.layout = layout if self.sharded else [layout]
        self.replicated = {key for key in self.layout[0]
                           if self.sharded and "model" not in specs[key]}
        self.tied = [[shard[key] for shard in self.layout] for key in self.replicated]
        self.owned = [self._canonical(i, key) for i, shard in enumerate(self.layout)
                      for key in shard if i == 0 or key not in self.replicated]
        self.opt = optimizer(self.owned)
        self.last: Optional[TrainState] = None

    def _canonical(self, i: int, key: str) -> torch.Tensor:
        """The parameter the optimizer steps for shard i's ``key``."""
        return self.layout[0 if key in self.replicated else i][key]

    def state(self, step: int) -> TrainState:
        keyed = [{key: self.opt.state[self._canonical(i, key)] for key in shard
                  if self._canonical(i, key) in self.opt.state}
                 for i, shard in enumerate(self.layout)]
        hyper = [{k: v for k, v in g.items() if k != "params"} for g in self.opt.param_groups]
        params = (ShardedParams(self.layout, self.cfg, self.mesh) if self.sharded
                  else self.layout[0])
        st = TrainState(step=step, params=params,
                        opt_state={"param_groups": hyper,
                                   "state": keyed if self.sharded else keyed[0]})
        self.last = st
        return st

    @torch.no_grad()
    def load(self, state: TrainState) -> None:
        """Copy a state that this trainer did not return last into its model
        and optimizer."""
        params = state.params if self.sharded else [state.params]
        if len(params) != len(self.layout):
            raise ValueError(f"a state of {len(params)} shards for a model of "
                             f"{len(self.layout)}")
        for mine, theirs in zip(self.layout, params):
            for key, p in mine.items():
                if theirs[key] is not p:
                    p.copy_(theirs[key])
        opt = state.opt_state or {}
        for group, hyper in zip(self.opt.param_groups, opt.get("param_groups", ())):
            group.update({k: v for k, v in hyper.items() if k != "params"})
        keyed = opt.get("state", {})
        keyed = keyed if self.sharded else [keyed]
        self.opt.state.clear()
        for i, shard in enumerate(keyed):
            for key, entry in shard.items():
                p = self._canonical(i, key)
                self.opt.state[p] = {
                    name: (v.to(p.device).clone() if v.shape == p.shape else v.clone())
                    if isinstance(v, torch.Tensor) else v
                    for name, v in entry.items()}
        self.last = None

    def reduce_grads(self, all_sum: Optional[Callable]) -> torch.Tensor:
        """Sum each replicated weight's copies' gradients into the first
        copy (and over processes with ``all_sum``) → the global grad norm."""
        for copies in self.tied:
            grads = [c.grad for c in copies if c.grad is not None]
            if not grads:
                continue
            total = grads[0].to(copies[0].device)
            for g in grads[1:]:
                total = total + g.to(total.device)
            for c in copies:
                c.grad = None
            copies[0].grad = total
        first = self.owned[0].device
        sq = torch.zeros((), dtype=torch.float32, device=first)
        for p in self.owned:
            if p.grad is None:
                continue
            if all_sum is not None:
                p.grad = all_sum(p.grad)
            sq = sq + p.grad.float().square().sum().to(first)
        return torch.sqrt(sq)

    @torch.no_grad()
    def apply(self) -> None:
        """The optimizer's step; gradients dropped; replicated copies on
        other devices take the first copy's value."""
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        for copies in self.tied:
            for c in copies[1:]:
                if c.data_ptr() != copies[0].data_ptr():
                    c.copy_(copies[0])


def _slices_all_sum(mesh) -> Optional[Callable]:
    """The cross-process sum of a data axis that spans processes
    (``parallel/dcn.py``'s slice meshes), else None."""
    if isinstance(mesh, SliceMesh) and mesh.num_slices > 1 and mesh.slice_axis == "data":
        return all_sum
    return None


def _decoder_model(cfg: LlamaConfig, mesh, layout):
    """A trainable decoder holding ``layout``'s tensors as its parameters."""
    if isinstance(layout, list):
        model = ShardedLlamaModel(cfg, mesh, layout, trainable=True)
        return model, [dict(m.named_parameters()) for m in model.shards], model.device
    first = next(iter(layout.values())).device
    with torch.device("meta"):
        model = LlamaModel(cfg)
    model.load_state_dict(layout, strict=True, assign=True)
    model.inv_freq = torch.from_numpy(
        rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg=cfg)).to(first)
    return model, dict(model.named_parameters()), first


def make_decoder_train_step(cfg: LlamaConfig, mesh=None, optimizer: Optional[Callable] = None,
                            learning_rate: float = 1e-4, seed: int = 0,
                            router_aux_coef: float = 0.02, params: Optional[Mapping] = None,
                            device=None) -> Tuple[TrainState, Callable]:
    """Build (state, step) for causal-LM training of the float decoder
    ``cfg`` on ``mesh`` (None: one device, ``device``; the card unless the
    caller names another). ``params``: a state dict or flax tree (else drawn
    from ``seed``, ``init_decoder_params``); ``optimizer``: a callable that
    takes the parameters (default AdamW at ``learning_rate``, optax's
    defaults).

    ``step(state, {'ids', 'mask'})`` → (state, metrics): ``loss`` (the
    next-token loss over the whole batch, its mask count the denominator,
    plus ``router_aux_coef`` times the load-balancing loss for MoE),
    ``grad_norm`` (the global norm of the gradients) and, for MoE,
    ``aux_loss``."""
    if cfg.quantization != "none":
        raise ValueError(f"training takes the float decoder (quantization='none'), "
                         f"got {cfg.quantization!r}: quantized weights take no gradient")
    if mesh is None:
        from ragmeup_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh((1, 1, 1), devices=[resolve_device(device)])
    layout, specs = init_sharded_params(cfg, mesh, seed, params)
    model, live, first = _decoder_model(cfg, mesh, layout)
    model.train()
    trainer = _Trainer(live, specs, optimizer or _default_optimizer(learning_rate), cfg, mesh)
    num_experts = int(cfg.num_experts or 0)
    moe = num_experts > 0 and router_aux_coef > 0.0
    n_data = mesh.shape["data"]
    all_sum = _slices_all_sum(mesh)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state is not trainer.last:
            trainer.load(state)
        ids = torch.as_tensor(batch["ids"]).long().to(first)
        mask = torch.as_tensor(batch["mask"]).to(first)
        b, seq = ids.shape
        if b % n_data:
            raise ValueError(f"batch of {b} rows over a data axis of {n_data}")
        pos = torch.arange(seq, device=first)
        bias = causal_bias(seq, seq, device=first)
        count = mask[:, 1:].float().sum()
        if all_sum is not None:
            count = all_sum(count)
        records: Optional[dict] = {} if moe else None
        logits = model(ids, pos, attn_bias=bias, router_records=records)
        loss = _masked_nll(logits, ids, mask)[0] / torch.clamp_min(count, 1.0)
        aux = None
        if moe:
            aux = moe_load_balancing_loss(records, num_experts, all_sum).to(first)
            loss = loss + router_aux_coef * aux
        loss.backward()
        gnorm = trainer.reduce_grads(all_sum)
        trainer.apply()
        loss = loss.detach()
        metrics = {"loss": all_sum(loss) if all_sum is not None else loss,
                   "grad_norm": gnorm}
        if moe:
            aux = aux.detach()
            metrics["aux_loss"] = all_sum(aux) if all_sum is not None else aux
        return trainer.state(state.step + 1), metrics

    return trainer.state(0), step_fn


def make_encoder_train_step(cfg: BertConfig, mesh=None, optimizer: Optional[Callable] = None,
                            learning_rate: float = 2e-5, temperature: float = 0.05,
                            seed: int = 0, params: Optional[Mapping] = None,
                            device=None) -> Tuple[TrainState, Callable]:
    """Contrastive fine-tuning step for the sentence encoder: a batch of
    (query_ids, doc_ids) pairs ``{'q_ids', 'q_mask', 'd_ids', 'd_mask'}``,
    in-batch negatives over the whole batch, mean-pooled f32 embeddings.
    The encoder lives on the mesh's first device (``device`` without a
    mesh); ``params`` a state dict or flax tree, else flax's initializers
    drawn from ``seed`` (``BertEncoder.init_weights``)."""
    first = (canonical(mesh.devices.flat[0]) if mesh is not None
             else resolve_device(device))
    model = BertEncoder(cfg, device=first)
    if params is None:
        model.init_weights(torch.Generator(device=first).manual_seed(seed))
    else:
        model.load_state_dict(_float32(params, first), strict=True)
    model.train()
    trainer = _Trainer(dict(model.named_parameters()), None,
                       optimizer or _default_optimizer(learning_rate))

    def embed(ids, mask):
        hidden = model(ids, mask)
        return mean_pool(hidden.float(), mask)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state is not trainer.last:
            trainer.load(state)
        t = {k: torch.as_tensor(v).long().to(first) for k, v in batch.items()}
        loss = contrastive_loss(embed(t["q_ids"], t["q_mask"]),
                                embed(t["d_ids"], t["d_mask"]), temperature)
        loss.backward()
        trainer.reduce_grads(None)
        trainer.apply()
        return trainer.state(state.step + 1), {"loss": loss.detach()}

    return trainer.state(0), step_fn
