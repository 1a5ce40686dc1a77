"""Sparse-MoE training in the port against the JAX package on the CPU: the
grouped GEMM's backward (``ops/moe_matmul.GroupedKernelPath``) and the MoE
decoder train step.

The grouped Function's dx and dw are held to JAX's custom VJP
(``_grouped_kernel_path``, Pallas in interpret mode; rtol/atol 1e-3 as
tests/test_moe.py's gradient test, bf16 rows 2e-2 for their one rounding)
and to autograd through the port's differentiable fallback (f32, 1e-5). A
spy on ``grouped_kernel_call`` records that the forward and dx both take
the kernel route (the card launches #11/#12 there). dx on the stacks'
transposed view as they lie equals the transposed copy's route bit for bit;
at the full-stack route over f32 stacks (an empty group, a group cut by
a chunk boundary) dx and dw equal ``jax.vjp`` of the JAX function; with the
tensors marked CUDA (a stand-in library) the backward makes no transposed
copy of the stacks and no one-hot product: the stack kernel's dx entry and
the dw kernel's. The MoE step at 512-wide
experts (so "on" reaches the kernel route) under "auto" and "on": loss,
grad norm and aux loss equal to JAX's (rtol 1e-5 at step 1, 1e-4 at step
3), the router moved, and under SGD at lr 1 the parameters after a step
(the gradients) within atol 1e-5; on a (2, 2, 2)
mesh equal to one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.ops import moe_matmul as jmm
from ragmeup_tpu.parallel import mesh as jmesh
from ragmeup_tpu.train import train as jtrain
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.models import convert, decoder
from ragmeup_tpu_torch.ops import moe_matmul as mm
from ragmeup_tpu_torch.parallel import mesh, tp
from ragmeup_tpu_torch.train import train
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

LR = 1e-3
GSZ = [70, 30, 0, 28]


def _operands(dtype, seed=2):
    rng = np.random.default_rng(seed)
    e, k, n, m = 4, 1024, 512, sum(GSZ)
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, w, r


def _port_grads(x, w, r, dtype, fn):
    xt = torch.from_numpy(x).to(decoder._DTYPES[dtype]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fn(xt, wt, torch.tensor(GSZ))
    (out.float() * torch.from_numpy(r)).sum().backward()
    return xt.grad.float().numpy(), wt.grad.numpy(), out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_backward_matches_jax_custom_vjp(dtype):
    x, w, r = _operands(dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    gsz = jnp.asarray(GSZ, jnp.int32)

    def loss(xj, wj):
        return jnp.sum(jmm.moe_grouped_matmul(xj, wj, gsz).astype(jnp.float32) * r)

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(w))
    gx, gw, _ = _port_grads(x, w, r, dtype, lambda a, b, g: mm.moe_grouped_matmul(a, b, g))
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(gx, np.asarray(jgx, np.float32), **tol)
    np.testing.assert_allclose(gw, np.asarray(jgw), **tol)
    assert gw.dtype == np.float32


def test_grouped_backward_matches_autograd_through_the_fallback():
    x, w, r = _operands("float32")
    gx, gw, out = _port_grads(x, w, r, "float32",
                              lambda a, b, g: mm.moe_grouped_matmul(a, b, g))
    assert out.grad_fn is not None and "GroupedKernelPath" in type(out.grad_fn).__name__
    fx, fw, _ = _port_grads(x, w, r, "float32",
                            lambda a, b, g: mm._grouped_fallback(a, b, g, None))
    np.testing.assert_allclose(gx, fx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw, fw, rtol=1e-5, atol=1e-5)
    # rows past the groups take no gradient from dw's one-hot
    gsz = torch.tensor([2, 0, 1, 0])
    xs = torch.randn(5, 8)
    dw = mm.grouped_weight_grad(xs, torch.ones(5, 4), gsz, 4)
    assert torch.allclose(dw[0], xs[:2].T @ torch.ones(2, 4))
    assert torch.equal(dw[1], torch.zeros(8, 4)) and torch.equal(dw[3], torch.zeros(8, 4))


def test_grouped_forward_and_dx_take_the_kernel_route(monkeypatch):
    """Forward and dx each reach ``grouped_kernel_call`` (the card's #11/#12
    launches); without a gradient asked for the Function is not entered."""
    calls = []
    real = mm.grouped_kernel_call

    def spy(xs, w, scale, gsz, tm, stack):
        calls.append((tuple(xs.shape), tuple(w.shape), stack))
        return real(xs, w, scale, gsz, tm, stack)
    monkeypatch.setattr(mm, "grouped_kernel_call", spy)
    applied = []
    apply = mm.GroupedKernelPath.apply
    monkeypatch.setattr(mm.GroupedKernelPath, "apply", lambda *a: applied.append(1) or apply(*a))
    x, w, r = _operands("float32")
    _port_grads(x, w, r, "float32", lambda a, b, g: mm.moe_grouped_matmul(a, b, g))
    m = sum(GSZ)
    assert [c[:2] for c in calls] == [((m, 1024), (4, 1024, 512)), ((m, 512), (4, 512, 1024))]
    assert applied == [1]
    calls.clear()
    with torch.no_grad():
        mm.moe_grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.tensor(GSZ))
    assert applied == [1] and len(calls) == 1


# (rows dtype, stacks dtype, group sizes): the full-stack route (bf16
# rows: the stack kernel's dx orientation on the card), f32 rows (the
# padded layout's f32 kernel, which takes a contiguous copy), bf16 stacks
DX_CASES = {
    "bf16 rows, f32 stacks": ("bfloat16", torch.float32, GSZ),
    "bf16 rows, bf16 stacks": ("bfloat16", torch.bfloat16, GSZ),
    "f32 rows, f32 stacks": ("float32", torch.float32, GSZ),
    "chunk-cut group": ("bfloat16", torch.float32, [900, 0, 700, 60]),
}


@pytest.mark.parametrize("case", list(DX_CASES))
def test_dx_on_stacks_as_they_lie_equals_the_transposed_copy(case):
    """moe_grouped_matmul(dy, w.transpose(1, 2), gsz) on the view, as
    GroupedKernelPath's backward now calls it, equals the call on the
    contiguous transposed copy bit for bit, on each route; the view takes
    the full-stack route's padded layout where the copy does."""
    xdt, wdt, gsz = DX_CASES[case]
    rng = np.random.default_rng(4)
    e, k, n, m = 4, 512, 1024, sum(gsz)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        decoder._DTYPES[xdt])
    w = torch.from_numpy((rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)).to(wdt)
    view = w.transpose(1, 2)
    assert mm.stacks_transposed(view)
    got = mm.moe_grouped_matmul(dy, view, torch.tensor(gsz))
    want = mm.moe_grouped_matmul(dy, view.contiguous(), torch.tensor(gsz))
    assert got.shape == (m, k) and torch.equal(got, want)


def test_stack_kernel_takes_f32_stacks():
    """bf16 rows in 128-row tiles over f32 stacks (a train step's master
    weights) now run #12's stack kernel, not the grouped-rows kernel."""
    for wdt in (torch.int8, torch.bfloat16, torch.float32):
        assert mm.stack_kernel_takes(128, 4096, 14336, torch.bfloat16, wdt)
        assert not mm.rows_kernel_takes(128, 4096, 14336, torch.bfloat16, wdt, True)
    assert not mm.stack_kernel_takes(128, 4096, 14336, torch.float32, torch.float32)
    assert not mm.stack_kernel_takes(64, 4096, 14336, torch.bfloat16, torch.float32)


def test_stack_route_backward_matches_jax_vjp():
    """bf16 rows over f32 stacks on the full-stack route (tm 128), groups
    [900, 0, 700, 60]: group 2 is cut by the chunk boundary at row 1,540
    (2,048 - 4 x 127) and group 1 is empty. dx and dw of the port's
    Function against jax.vjp of the JAX package's moe_grouped_matmul
    (Pallas in interpret mode, the same numpy-seeded inputs): dx within one
    bf16 ulp of its largest value (each side sums in f32 in its own order
    and rounds once to bf16), dw within 1e-5 of its largest value (f32 sums
    of the same bf16 products); the empty expert's dw is zero."""
    gsz = [900, 0, 700, 60]
    rng = np.random.default_rng(3)
    e, k, n, m = 4, 512, 512, sum(gsz)
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)
    dy = (rng.standard_normal((m, n)) * 0.1).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    dy = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    g = jnp.asarray(gsz, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jmm.moe_grouped_matmul(a, b, g),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = mm.moe_grouped_matmul(xt, wt, torch.tensor(gsz))
    assert "GroupedKernelPath" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    jdx = np.asarray(jdx.astype(jnp.float32))
    np.testing.assert_allclose(xt.grad.float().numpy(), jdx, rtol=0,
                               atol=2.0 ** -7 * np.abs(jdx).max())
    jdw = np.asarray(jdw)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=0, atol=1e-5 * np.abs(jdw).max())
    assert not wt.grad[1].any()


class _Entries:
    """Stands in for the kernel library: records each C entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


def test_backward_on_the_card_takes_no_copy_and_no_one_hot(monkeypatch):
    """With every tensor marked CUDA and a stand-in library, a forward and
    backward of the Function (bf16 rows over f32 stacks, the full-stack
    route) calls the stack kernel's forward entry, its dx entry on the
    stored stacks and the dw kernel: no contiguous copy of the transposed
    stacks, no einsum. Launches count as moe_grouped_stack "w=f32" and "dx
    w=f32" and moe_grouped_wgrad."""
    lib = _Entries()
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: 132)
    x, w, r = _operands("bfloat16")
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    copies, einsums = [], []
    contiguous = torch.Tensor.contiguous

    def spy_contiguous(t, *a, **kw):
        if t.dim() == 3 and not t.is_contiguous():
            copies.append(tuple(t.shape))
        return contiguous(t, *a, **kw)
    real_einsum = torch.einsum
    monkeypatch.setattr(torch.Tensor, "contiguous", spy_contiguous)
    monkeypatch.setattr(torch, "einsum", lambda *a: einsums.append(a[0]) or real_einsum(*a))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    kernels.reset_counts()
    try:
        out = mm.moe_grouped_matmul(xt, wt, torch.tensor(GSZ))
        out.backward(torch.ones_like(out))
    finally:
        monkeypatch.undo()
    assert lib.calls == ["rk_moe_grouped_stack", "rk_moe_grouped_stack_t",
                         "rk_moe_grouped_wgrad"]
    assert copies == [] and einsums == []
    assert kernels.variant_counts() == {"moe_grouped_stack w=f32": 1,
                                        "moe_grouped_stack dx w=f32": 1}
    assert kernels.launch_counts()["moe_grouped_wgrad"] == 1
    kernels.reset_counts()


def test_kernel_launch_refuses_a_gradient():
    """A CUDA wrapper's checks refuse tensors that a gradient would pass
    through (the kernel's output has no autograd edge)."""
    t = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.require_cuda("int8_matmul", t)
    with torch.no_grad():
        kernels.require_cuda("int8_matmul", t)
    kernels.require_cuda("int8_matmul", torch.zeros(4))


# -- the MoE decoder step --------------------------------------------------------------

def _moe_kw(grouped):
    return dict(hidden_size=512, intermediate_size=512, num_layers=1, num_heads=4,
                num_kv_heads=2, num_experts=4, num_experts_per_tok=2, dtype="float32",
                moe_grouped=grouped)


def _batch(vocab, b=2, s=32):
    rng = np.random.default_rng(0)
    mask = np.ones((b, s), np.int32)
    mask[1, 25:] = 0
    return {"ids": rng.integers(0, vocab, (b, s)).astype(np.int32), "mask": mask}


@pytest.mark.parametrize("grouped", ["auto", "on"])
def test_moe_step_matches_jax(grouped, monkeypatch):
    """AdamW: loss, grad norm and aux loss over three steps. SGD at lr 1:
    the parameters after one step are the init less the gradients, so they
    hold every gradient to JAX's (AdamW's first step divides each by its own
    size, which turns a rounding of a near-zero gradient into up to 2 lr)."""
    import optax
    kw = _moe_kw(grouped)
    cfg = decoder.LlamaConfig.tiny(**kw)
    batch = _batch(cfg.vocab_size)
    jm = jmesh.make_mesh((1, 1, 1), devices=jax.devices()[:1])
    jmodel = jdec.LlamaModel(jdec.LlamaConfig.tiny(**kw))
    jstate, jstep = jtrain.make_decoder_train_step(jmodel, jm, example_batch=batch,
                                                   learning_rate=LR)
    # a copy: the JAX step donates its state's buffers
    init = jax.tree_util.tree_map(np.array, jstate.params)
    applied = []
    real = mm.GroupedKernelPath.apply
    monkeypatch.setattr(mm.GroupedKernelPath, "apply",
                        lambda *a: applied.append(1) or real(*a))
    state, step = train.make_decoder_train_step(cfg, learning_rate=LR, params=init,
                                                device="cpu")
    router0 = state.params["layers.0.mlp.router"].detach().clone()
    for i in range(3):
        jstate, jmt = jstep(jstate, batch)
        state, mt = step(state, batch)
        tol = dict(rtol=1e-5) if i == 0 else dict(rtol=1e-4)
        for key in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(float(mt[key]), float(jmt[key]),
                                       err_msg=f"step {i + 1} {key}", **tol)
        assert float(mt["aux_loss"]) >= 1.0 - 1e-5
    assert not torch.equal(state.params["layers.0.mlp.router"], router0)
    # "on" runs gate, up and down through the Function each step; "auto"
    # (S = 128 > 4E) the all-experts einsum
    assert len(applied) == (9 if grouped == "on" else 0)
    jstate, jstep = jtrain.make_decoder_train_step(jmodel, jm, optimizer=optax.sgd(1.0),
                                                   example_batch=batch)
    state, step = train.make_decoder_train_step(
        cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=1.0), params=init, device="cpu")
    jstate, _ = jstep(jstate, batch)
    state, _ = step(state, batch)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[key].numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("grouped", ["auto", "on"])
def test_moe_step_on_a_222_mesh_matches_one_device(grouped):
    cfg = decoder.LlamaConfig.tiny(**_moe_kw(grouped))
    batch = _batch(cfg.vocab_size, b=4, s=16)
    gen = torch.Generator().manual_seed(1)
    init = decoder.init_decoder_params(cfg, gen, "cpu")
    m = mesh.make_mesh((2, 2, 2), devices=["cpu"] * 8)
    # SGD at lr 1: the parameters hold the summed gradients (see above)
    sgd = lambda ps: torch.optim.SGD(ps, lr=1.0)  # noqa: E731
    s_one, step_one = train.make_decoder_train_step(cfg, optimizer=sgd, params=init,
                                                    device="cpu")
    s_tp, step_tp = train.make_decoder_train_step(cfg, m, optimizer=sgd, params=init)
    # EP: each shard holds half the experts and half the router's columns
    assert s_tp.params[0]["layers.0.mlp.gate"].shape == (2, 512, 512)
    assert s_tp.params[1]["layers.0.mlp.router"].shape == (512, 2)
    for i in range(2):
        s_one, a = step_one(s_one, batch)
        s_tp, b = step_tp(s_tp, batch)
        for key in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(float(b[key]), float(a[key]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {key}")
    got = tp.tp_gather_model(s_tp.params, cfg, m)
    for key, t in s_one.params.items():
        np.testing.assert_allclose(got[key].detach().numpy(), t.detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)
