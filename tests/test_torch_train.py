"""Training of the port (``ragmeup_tpu_torch/train/``) against the JAX
package's on the CPU.

The same numpy-seeded batches go through both packages, the JAX init
carried across by ``models/convert.py``. Held to JAX: the three losses
(rtol 1e-6), the decoder train step on one device and on a (2, 2, 2) mesh
(losses and grad norms rtol 1e-5 at step 1 and 1e-4 at step 3, parameters
after step 1 atol 1e-5; the bf16-compute config loss rtol 1e-2 and grad
norm rtol 5e-2: bf16 activations round differently in the two packages'
op orders), the encoder step, the checkpoint round trip (a TP-written
checkpoint restored on one device and back) and train → save → serve
(greedy ids equal to JAX's ``LocalLLM`` on the same restored params, apart
from a near-tie within one bf16 ulp). The port's (2, 2, 2) step runs on
"cpu" repeated, JAX's on conftest's 8 virtual CPU devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.models.hf_loader import quantize_decoder_params as jquantize
from ragmeup_tpu.parallel import mesh as jmesh
from ragmeup_tpu.train import train as jtrain
from ragmeup_tpu_torch.models import convert, decoder, encoder, hf_loader, tokenizer
from ragmeup_tpu_torch.parallel import mesh, tp
from ragmeup_tpu_torch.train import checkpoint, train
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

LR = 1e-3
STEP1 = dict(rtol=1e-5)
STEP3 = dict(rtol=1e-4)
PARAMS = dict(rtol=0, atol=1e-5)


def _np(tree):
    """A numpy copy (a donated JAX buffer may be reused by the next step)."""
    return jax.tree_util.tree_map(np.array, tree)


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[1, 12:] = 0
    return {"ids": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), "mask": mask}


def _jax_run(jcfg, shape, batch, steps=3):
    """JAX's step on ``shape``: (its init as numpy, [metrics], params after step 1)."""
    n = int(np.prod(shape))
    m = jmesh.make_mesh(shape, devices=jax.devices()[:n])
    state, step = jtrain.make_decoder_train_step(jdec.LlamaModel(jcfg), m, example_batch=batch,
                                                 learning_rate=LR)
    init = _np(state.params)
    metrics, after1 = [], None
    for i in range(steps):
        state, mt = step(state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
        if i == 0:
            after1 = convert.flax_to_state_dict(_np(state.params))
    return init, metrics, after1


def _port_run(cfg, port_mesh, init, batch, steps=3):
    state, step = train.make_decoder_train_step(cfg, port_mesh, learning_rate=LR, params=init,
                                                device="cpu")
    metrics, after1 = [], None
    for i in range(steps):
        state, mt = step(state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
        if i == 0:
            p = state.params
            whole = p if isinstance(p, dict) else tp.tp_gather_model(p, cfg, port_mesh)
            after1 = {k: v.detach().clone() for k, v in whole.items()}
    return state, metrics, after1


def _close_metrics(got, want, first=STEP1, later=STEP3):
    assert got[0].keys() == want[0].keys()
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], err_msg=f"step {i + 1} {key}",
                                       **(first if i == 0 else later))


def _close_params(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().float().numpy(), w.float().numpy(),
                                   err_msg=key, **PARAMS)


# -- losses -------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 9, 40)).astype(np.float32) * 3
    ids = rng.integers(0, 40, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.3).astype(np.int32)
    got = train.decoder_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                             torch.from_numpy(mask))
    want = jtrain.decoder_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-masked batch divides by 1, as JAX's maximum(count, 1)
    zero = np.zeros_like(mask)
    np.testing.assert_allclose(
        float(train.decoder_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                                 torch.from_numpy(zero))),
        float(jtrain.decoder_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(zero))),
        atol=1e-7)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    d = q + 0.5 * rng.standard_normal((6, 16)).astype(np.float32)
    for t in (0.05, 1.0):
        np.testing.assert_allclose(
            float(train.contrastive_loss(torch.from_numpy(q), torch.from_numpy(d), t)),
            float(jtrain.contrastive_loss(jnp.asarray(q), jnp.asarray(d), t)), rtol=1e-6)
    e = 8
    probs = [torch.softmax(torch.from_numpy(rng.standard_normal((12, e)).astype(np.float32)), -1)
             for _ in range(3)]
    topi = [torch.argsort(p, dim=-1, descending=True, stable=True)[:, :2] for p in probs]
    inter = {f"layer_{i}": {"mlp": {"router_probs": (jnp.asarray(p.numpy()),),
                                    "router_topi": (jnp.asarray(t.numpy()),)}}
             for i, (p, t) in enumerate(zip(probs, topi))}
    got = train.moe_load_balancing_loss({"router_probs": probs, "router_topi": topi}, e)
    np.testing.assert_allclose(float(got), float(jtrain.moe_load_balancing_loss(inter, e)),
                               rtol=1e-6)


def test_load_balancing_uniform_is_one_and_no_moe_is_zero():
    e, t, k = 8, 16, 2
    probs = torch.full((t, e), 1.0 / e)
    topi = torch.arange(t * k).reshape(t, k) % e  # every expert equally often
    got = train.moe_load_balancing_loss({"router_probs": [probs] * 2,
                                         "router_topi": [topi] * 2}, e)
    assert float(got) == pytest.approx(1.0, abs=1e-6)
    assert float(train.moe_load_balancing_loss({}, e)) == 0.0


# -- the decoder step ---------------------------------------------------------------

@pytest.mark.parametrize("tie", [True, False])
def test_decoder_step_matches_jax_on_one_device(tie):
    kw = dict(num_heads=4, num_kv_heads=2, dtype="float32", tie_embeddings=tie)
    batch = _batch(decoder.LlamaConfig.tiny(**kw))
    init, want, want1 = _jax_run(jdec.LlamaConfig.tiny(**kw), (1, 1, 1), batch)
    state, got, got1 = _port_run(decoder.LlamaConfig.tiny(**kw), None, init, batch)
    _close_metrics(got, want)
    _close_params(got1, want1)
    assert state.step == 3
    assert got[2]["loss"] < got[0]["loss"]


def test_decoder_step_bf16_compute_matches_jax():
    """f32 weights, bf16 activations: the stated looser tolerances."""
    kw = dict(num_heads=4, num_kv_heads=2, dtype="bfloat16")
    batch = _batch(decoder.LlamaConfig.tiny(**kw))
    init, want, _ = _jax_run(jdec.LlamaConfig.tiny(**kw), (1, 1, 1), batch)
    _, got, _ = _port_run(decoder.LlamaConfig.tiny(**kw), None, init, batch)
    loose = dict(rtol=1e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], **loose)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=5e-2)


def test_decoder_step_on_a_222_mesh_matches_one_device_and_jax():
    kw = dict(num_heads=4, num_kv_heads=2, dtype="float32")
    cfg = decoder.LlamaConfig.tiny(**kw)
    batch = _batch(cfg)
    init, want, want1 = _jax_run(jdec.LlamaConfig.tiny(**kw), (2, 2, 2), batch)
    m = mesh.make_mesh((2, 2, 2), devices=["cpu"] * 8)
    state, got, got1 = _port_run(cfg, m, init, batch)
    _, one, one1 = _port_run(cfg, None, init, batch)
    _close_metrics(got, one)
    _close_metrics(got, want)
    _close_params(got1, want1)
    _close_params(got1, one1)
    # TP: each model shard's q_proj holds half the columns
    q = [shard["layers.0.attention.q_proj.kernel"] for shard in state.params]
    assert len(q) == 2 and all(t.shape == (64, 32) for t in q)
    full = cfg.num_heads * cfg.head_dim
    assert sum(t.shape[1] for t in q) == full
    # replicated weights stay one value on every shard
    for key in ("final_norm.scale", "layers.1.input_norm.scale"):
        assert torch.equal(state.params[0][key], state.params[1][key])


def test_step_adopts_a_foreign_state_and_refuses_quantized_weights():
    cfg = decoder.LlamaConfig.tiny(dtype="float32")
    batch = _batch(cfg)
    s1, step1 = train.make_decoder_train_step(cfg, device="cpu", learning_rate=LR, seed=3)
    s2, step2 = train.make_decoder_train_step(cfg, device="cpu", learning_rate=LR, seed=4)
    s1, m1 = step1(s1, batch)
    # step2 takes step1's state: its parameters and AdamW moments are copied in
    a, ma = step2(s1, batch)
    b, mb = step1(s1, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key])
    with pytest.raises(ValueError, match="float decoder"):
        train.make_decoder_train_step(decoder.LlamaConfig.tiny(quantization="int8"),
                                      device="cpu")


def test_encoder_step_matches_jax():
    jcfg = dataclasses.replace(jenc.BertConfig.tiny(), dtype="float32")
    cfg = dataclasses.replace(encoder.BertConfig.tiny(), dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"q_ids": rng.integers(5, cfg.vocab_size, (4, 12)).astype(np.int32),
             "q_mask": np.ones((4, 12), np.int32),
             "d_ids": rng.integers(5, cfg.vocab_size, (4, 12)).astype(np.int32),
             "d_mask": np.ones((4, 12), np.int32)}
    batch["d_mask"][2, 9:] = 0
    jm = jmesh.make_mesh((2, 2, 2), devices=jax.devices()[:8])
    # lr 1e-4: at 1e-3 the tiny encoder's loss falls to 1e-3 by step 3,
    # where its rounding is a large share of it
    jstate, jstep = jtrain.make_encoder_train_step(jenc.BertEncoder(jcfg), jm,
                                                   example_batch=batch, learning_rate=1e-4)
    init = _np(jstate.params)
    state, step = train.make_encoder_train_step(cfg, learning_rate=1e-4, params=init,
                                                device="cpu")
    got, want = [], []
    for _ in range(3):
        jstate, jm_ = jstep(jstate, batch)
        state, m_ = step(state, batch)
        want.append(float(jm_["loss"]))
        got.append(float(m_["loss"]))
    np.testing.assert_allclose(got[0], want[0], **STEP1)
    np.testing.assert_allclose(got[1:], want[1:], **STEP3)
    assert got[2] < got[0]


# -- checkpoints ----------------------------------------------------------------------

def test_checkpoint_round_trip_and_tp_to_one_device(tmp_path):
    cfg = decoder.LlamaConfig.tiny(num_heads=4, num_kv_heads=2, dtype="float32")
    batch = _batch(cfg)
    m = mesh.make_mesh((2, 2, 2), devices=["cpu"] * 8)
    state, step = train.make_decoder_train_step(cfg, m, learning_rate=LR)
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoint.save_train_state(ckpt_dir + "/", state)
    path = checkpoint.latest_checkpoint(ckpt_dir + "/")
    assert path is not None and path.endswith("step_2")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    # resume on the mesh and on one device: both equal a run that never stopped
    tpl_tp, step_tp = train.make_decoder_train_step(cfg, m, learning_rate=LR, seed=9)
    tpl_one, step_one = train.make_decoder_train_step(cfg, learning_rate=LR, seed=9,
                                                      device="cpu")
    r_tp = checkpoint.restore_train_state(path, tpl_tp)
    r_one = checkpoint.restore_train_state(path, tpl_one)
    assert r_tp.step == r_one.step == 2
    whole = tp.tp_gather_model(state.params, cfg, m)
    for key, t in r_one.params.items():
        assert torch.equal(t, whole[key]), key
    q = r_tp.params[0]["layers.0.attention.q_proj.kernel"]
    assert q.shape == (64, 32)
    a_tp, m_tp = step_tp(r_tp, batch)
    a_one, m_one = step_one(r_one, batch)
    straight, m_straight = step(state, batch)
    np.testing.assert_allclose(float(m_tp["loss"]), float(m_straight["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_one["loss"]), float(m_straight["loss"]), rtol=1e-5)
    # the step after the resume reads the restored AdamW moments and step
    # count: every parameter after it equals the uninterrupted run's (the
    # same mesh bit for bit; one device within 1e-7, the TP sums' order)
    want = tp.tp_gather_model(straight.params, cfg, m)
    got_tp = tp.tp_gather_model(a_tp.params, cfg, m)
    for key, t in want.items():
        assert torch.equal(got_tp[key], t), key
        np.testing.assert_allclose(a_one.params[key].detach().numpy(), t.detach().numpy(),
                                   rtol=0, atol=1e-7, err_msg=key)
    # a checkpoint written on one device restores onto the mesh
    p1 = checkpoint.save_train_state(str(tmp_path / "one"), r_one, step=7)
    assert p1.endswith("step_7")
    back = checkpoint.restore_train_state(p1, tpl_tp)
    assert torch.equal(tp.tp_gather_model(back.params, cfg, m)["token_embedding"],
                       r_one.params["token_embedding"])
    # bare params
    pp = checkpoint.save_params(str(tmp_path / "bare"), state.params)
    got = checkpoint.restore_params(pp)
    for key, t in tp.tp_gather_model(state.params, cfg, m).items():
        assert torch.equal(got[key], t), key
    laid = checkpoint.restore_params(pp, tpl_tp.params)
    assert laid[1]["layers.0.mlp.down_proj.kernel"].shape == (64, 64)


def test_train_to_serve_matches_jax(tmp_path):
    """Train on the mesh, checkpoint, restore into a fresh template,
    quantize int8 and serve: the port's greedy ids equal JAX's LocalLLM
    on the same restored params."""
    kw = dict(num_heads=4, num_kv_heads=2, tie_embeddings=False, dtype="float32")
    cfg = decoder.LlamaConfig.tiny(**kw)
    batch = _batch(cfg)
    m = mesh.make_mesh((2, 2, 2), devices=["cpu"] * 8)
    state, step = train.make_decoder_train_step(cfg, m, learning_rate=LR)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert float(m2["loss"]) < float(m1["loss"])
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoint.save_train_state(ckpt_dir, state)
    tpl, _ = train.make_decoder_train_step(cfg, m, learning_rate=LR, seed=5)
    restored = checkpoint.restore_train_state(checkpoint.latest_checkpoint(ckpt_dir), tpl)
    host = tp.tp_gather_model(restored.params, cfg, m)
    assert torch.equal(host["lm_head"], tp.tp_gather_model(state.params, cfg, m)["lm_head"])
    qparams = hf_loader.quantize_decoder_params({k: v.detach() for k, v in host.items()},
                                                bits=8)
    qcfg = decoder.LlamaConfig.tiny(**dict(kw, quantization="int8", dtype="bfloat16"))
    llm = decoder.LocalLLM(qcfg, tokenizer.SimpleTokenizer(qcfg.vocab_size), params=qparams,
                           device="cpu")
    got = llm.generate([3, 9, 4], max_new_tokens=8, temperature=0.0, speculative="off")
    # JAX quantizes and serves the same restored params
    flat = {k: v.detach().numpy() for k, v in host.items()}
    jtree = {}
    for key, v in flat.items():
        node = jtree
        parts = key.split(".")
        i = 0
        while i < len(parts) - 1:
            name = parts[i]
            if name == "layers":
                name, i = f"layer_{parts[i + 1]}", i + 1
            node = node.setdefault(name, {})
            i += 1
        node[parts[-1]] = v
    jq = jquantize(jtree, bits=8)
    jcfg = jdec.LlamaConfig.tiny(**dict(kw, quantization="int8", dtype="bfloat16"))
    jllm = jdec.LocalLLM(jcfg, jtok.SimpleTokenizer(jcfg.vocab_size), params=jq)
    want = jllm.generate([3, 9, 4], max_new_tokens=8, temperature=0.0, speculative="off")
    assert len(got) == 8
    if list(got) != list(want):
        # a near-tie: the first differing step's top two logits within one bf16 ulp
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        lg = llm.forward_logits([3, 9, 4] + list(got[:j]))[-1]
        top = np.sort(lg)[-2:]
        assert top[1] - top[0] <= abs(top[1]) * 2 ** -7, (got, want)
