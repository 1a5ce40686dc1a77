"""The int4 expert gather (#13) on #4's decode kernels, modelled on the CPU:
each slot's row through the model of the decode kernel its route takes
(tensor cores for bf16 at groups 128 and 512, the scalar kernel for f32
and group 130) under ``int4_gather_plan``, held to
``moe_gather_matmul_int4_plain`` and to JAX's gather in interpret mode.
The cases sit in a file of their own, beside test_torch_kernel_plans.py
(whose decode models they use), so that a parallel run (``-n``, loadfile)
gives them a worker of their own."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu_torch.ops import moe_matmul as moe
from ragmeup_tpu_torch.ops import quant_matmul as qm
from test_torch_kernel_plans import (H100_SMS, INT4_TINY, _int4_decode_mma_plain,
                                     _int4_decode_plain)
from test_torch_moe_int4 import DTYPES, _close, _packed_experts
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)


def _gather_model(x, w_p, gs, ids, k_slice, tensor_cores):
    """The gather kernels' sums: each slot's row through the model of the
    decode kernel its route takes (tensor cores or scalar), against its
    expert, under the gather's plan."""
    model = _int4_decode_mma_plain if tensor_cores else _int4_decode_plain
    return torch.cat([model(x[s:s + 1], w_p[e], gs[e], k_slice)
                      for s, e in enumerate(ids.tolist())])


GATHER_IDS = {1: [3], 3: [2, 0, 2], 16: [1, 1, 0, 3, 2, 2, 3, 0, 0, 1, 3, 3, 2, 0, 1, 1]}


@functools.lru_cache(maxsize=None)
def _gather_case(shape, group, slots, dtype):
    """Packed experts (4 of them), one x row a slot, repeated experts, and
    the JAX gather's output on them (interpret mode)."""
    k, n = INT4_TINY[shape]
    rng = np.random.default_rng(k + group + slots)
    w_p, gs = _packed_experts(rng, group, k=k, n=n)
    x = rng.standard_normal((slots, k)).astype(np.float32)
    ids = np.asarray(GATHER_IDS[slots], np.int32)
    tile_k = qm.int4_tiling(k)[0]
    want = np.asarray(jmoe.moe_gather_matmul_int4(
        jnp.asarray(x, DTYPES[dtype][1]), jnp.asarray(w_p), jnp.asarray(gs), jnp.asarray(ids),
        tile_k, group, interpret=True).astype(jnp.float32))
    return x, w_p, gs, ids, want


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("slots", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [("tiny", 128), ("tiny", 512), ("short", 130)])
def test_int4_gather_model_matches_plain_and_jax(shape, group, dtype, slots, sms):
    """The kernel the gather's wrapper picks (tensor cores for bf16 where
    int4_decode_tensor_cores allows: groups 128 and 512; group 130 and f32
    the scalar kernel), modelled slot by slot under int4_gather_plan, held
    to moe_gather_matmul_int4_plain and to JAX's gather (interpret mode):
    distinct and repeated experts, the output rows in slot order."""
    x, w_p, gs, ids, want = _gather_case(shape, group, slots, dtype)
    k, n = INT4_TINY[shape]
    tile_k = qm.int4_tiling(k)[0]
    tdt = DTYPES[dtype][0]
    tx, tw, ts, ti = (torch.from_numpy(x).to(tdt), torch.from_numpy(w_p),
                      torch.from_numpy(gs), torch.from_numpy(ids))
    ks = moe.int4_gather_plan(slots, k, n, tile_k, group, sms)
    tc = qm.int4_decode_tensor_cores(tile_k, group, ks, tdt)
    assert tc == (dtype == "bfloat16" and group != 130)
    got = _gather_model(tx, tw, ts, ti, ks, tc)
    assert got.dtype == tdt and got.shape == (slots, n)
    _close(got, moe.moe_gather_matmul_int4_plain(tx, tw, ts, ti, tile_k, group).float().numpy(),
           dtype)
    _close(got, want, dtype)
