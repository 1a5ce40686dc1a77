"""Launch plans of the port's CUDA kernels, checked on the CPU.

The int4 grouped expert GEMM (#14, csrc/moe_matmul_int4.cu) cuts k into
slices of whole packing tiles on bf16 rows and adds the slices' f32
partials in slice order. Its plan is chosen on the host from the shapes and
the card's SM count, so it is held here: the slices cover k once, in order,
each a whole number of packing tiles, never none and never more than there
are tiles. The plain version evaluated slice by slice under that plan, the
partials added in slice order, agrees with the whole-k plain version and
with the JAX kernel in interpret mode, on both arithmetic routes, in f32
and bf16 (tolerances as tests/test_torch_moe_int4.py: 2e-5 of the largest
output in f32, one bf16 ulp of it in bf16).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu_torch.ops import moe_matmul as moe
from test_torch_moe_int4 import DTYPES, _close, _packed_experts

H100_SMS = 132
MIXTRAL = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
TINY = {"grouped": (1024, 512), "mlp gate": (512, 256), "mlp down": (256, 512)}


def _padded_rows(m: int, e: int = 8) -> int:
    """scatter_layout's padded strip for m rows over e experts, 16-row tiles."""
    return -(-(m + e * 15) // 16) * 16


# (k, n, packing tile, scale group, rows, SMs); groups 128 and 512 where
# the group divides the packing tile
PLAN_CASES = {f"{name} group={group} m={m} sms={sms}": (k, n, pack_tile, group, m, sms)
              for name, (k, n) in {**MIXTRAL, **TINY}.items()
              for pack_tile in ([512] if k % 512 == 0 else [k])
              for group in (128, 512) if pack_tile % group == 0
              for m in (1, 16, 392)
              for sms in (1, H100_SMS, 10_000)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_grouped_int4_plan_covers_k_in_whole_tiles(case):
    k, n, pack_tile, group, m, sms = PLAN_CASES[case]
    assert moe.grouped_int4_viable(m, 8, k, n, pack_tile, group, torch.bfloat16)
    mp = _padded_rows(m)
    tiles = k // pack_tile
    per = moe.grouped_int4_plan(mp, k, n, pack_tile, sms)
    ranges = moe.grouped_int4_slices(k, pack_tile, per)
    assert 1 <= len(ranges) <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % pack_tile == 0 and (k1 - k0) % pack_tile == 0
        assert (k1 - k0) // pack_tile <= per
    # the slices are as even as whole tiles allow
    widths = [k1 - k0 for k0, k1 in ranges]
    assert max(widths) - min(widths) <= per * pack_tile
    # the blocks it aims at on every SM, unless k has too few tiles
    target = moe._INT4_BLOCKS_PER_SM * sms
    blocks = (n // 128) * (mp // 16) * len(ranges)
    assert blocks >= target or len(ranges) == tiles
    # the fewest such slices: one fewer would not give the blocks
    if len(ranges) > 1:
        fewer = -(-tiles // (len(ranges) - 1))
        assert (n // 128) * (mp // 16) * -(-tiles // fewer) < target


def test_grouped_int4_plan_splits_mixtral_down_on_an_h100():
    """At Mixtral's batched decode (16 rows over 8 experts: 9 row tiles)
    the down projection (k 14336: 28 packing tiles, 32 column strips) is
    cut in four, gate/up (112 strips) in two."""
    mp = _padded_rows(16)
    slices = {name: len(moe.grouped_int4_slices(
        k, 512, moe.grouped_int4_plan(mp, k, n, 512, H100_SMS)))
        for name, (k, n) in MIXTRAL.items()}
    assert slices == {"gate": 2, "up": 2, "down": 4}


def _split_k_plain(xs, w_p, gs, gsz, pack_tile, group, per):
    """The plain arithmetic of each route over each slice of the plan, the
    f32 partials added in slice order and rounded once."""
    k = xs.shape[1]
    out = torch.empty((xs.shape[0], w_p.shape[2]), dtype=xs.dtype)
    lo = 0
    for ex, g in enumerate(gsz.tolist()):
        if g:
            acc = None
            for k0, k1 in moe.grouped_int4_slices(k, pack_tile, per):
                part = moe._int4_products(
                    xs[lo:lo + g, k0:k1].float()[None],
                    moe._unpack_int4_stack(w_p[ex:ex + 1, k0 // 2:k1 // 2], pack_tile),
                    gs[ex:ex + 1, k0 // group:k1 // group], pack_tile, group, xs.dtype)
                acc = part if acc is None else acc + part
            out[lo:lo + g] = acc[0].to(xs.dtype)
        lo += g
    return out


SPLIT_K = 1536       # three packing tiles of 512
SPLIT_GSZ = (3, 0, 5, 2)


@functools.lru_cache(maxsize=None)
def _split_inputs(group: int, dtype: str):
    """Packed experts (4, 768, 512), rows sorted by expert, and the JAX
    kernel's output on them (interpret mode)."""
    rng = np.random.default_rng(group + len(dtype))
    w_p, gs = _packed_experts(rng, group, k=SPLIT_K)
    gsz = np.asarray(SPLIT_GSZ, np.int32)
    x = rng.standard_normal((int(gsz.sum()), SPLIT_K)).astype(np.float32)
    jdt = DTYPES[dtype][1]
    want = np.asarray(jmoe.moe_grouped_matmul_int4(
        jnp.asarray(x, jdt), jnp.asarray(w_p), jnp.asarray(gs), jnp.asarray(gsz), 512,
        group).astype(jnp.float32))
    return x, w_p, gs, gsz, want


# SM counts that give one, two (2 + 1 tiles: uneven) and three slices
@pytest.mark.parametrize("sms,slices", [(1, 1), (4, 2), (100, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, 512])
def test_split_k_plain_matches_plain_and_jax(group, dtype, sms, slices):
    x, w_p, gs, gsz, want = _split_inputs(group, dtype)
    assert moe.grouped_int4_viable(x.shape[0], 4, SPLIT_K, 512, 512, group,
                                   DTYPES[dtype][0])
    per = moe.grouped_int4_plan(_padded_rows(x.shape[0], 4), SPLIT_K, 512, 512, sms)
    assert len(moe.grouped_int4_slices(SPLIT_K, 512, per)) == slices
    tx = torch.from_numpy(x).to(DTYPES[dtype][0])
    args = (torch.from_numpy(w_p), torch.from_numpy(gs), torch.from_numpy(gsz), 512, group)
    got = _split_k_plain(tx, *args, per)
    assert got.dtype == tx.dtype and got.shape == (x.shape[0], 512)
    _close(got, moe.moe_grouped_matmul_int4_plain(tx, *args).float().numpy(), dtype)
    _close(got, want, dtype)
