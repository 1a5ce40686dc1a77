"""The port's ``weighted_score_fuse`` against the JAX package's.

Both normalize each score map min-max in f64 (a range of 1.0 where all
scores are equal), skip empty maps, sum the weighted maps, order by
(-score, first sight) and cut to k. Ids and order must be equal, scores
within f64 rounding.
"""

import numpy as np
import pytest

from ragmeup_tpu.ops import fusion as jfusion
import ragmeup_tpu_torch.ops as ops
from ragmeup_tpu_torch.ops import fusion
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)


def _seeded_maps(seed, sizes, pool=40):
    """Score maps over ids drawn from one pool, so that they overlap."""
    rng = np.random.default_rng(seed)
    maps = []
    for n in sizes:
        ids = rng.choice(pool, size=n, replace=False)
        vals = rng.standard_normal(n) * rng.uniform(0.1, 10.0)
        maps.append({f"d{int(i)}": float(v) for i, v in zip(ids, vals)})
    return maps


CASES = {
    # tests/test_retrieval.py's case
    "retrieval": ([{"a": 10.0, "b": 8.0, "z": 0.0}, {"b": 1.0, "c": 0.5}],
                  [0.5, 0.5], 3),
    "empty map": ([{}, {"x": 3.0, "y": 1.0, "w": 2.0}], [0.7, 0.3], 5),
    "all empty": ([{}, {}], [0.5, 0.5], 4),
    "constant map": ([{"a": 2.0, "b": 2.0, "c": 2.0}, {"c": 5.0, "d": 1.0}],
                     [0.4, 0.6], 4),
    # every fused score equal: the order is first sight alone
    "ties": ([{"p": 1.0, "q": 1.0}, {"r": 4.0, "s": 4.0}], [1.0, 1.0], 4),
    "ties across maps": ([{"a": 0.0, "b": 1.0}, {"c": 1.0, "a": 0.0}],
                         [0.5, 0.5], 3),
    "k below union": (_seeded_maps(0, (12, 9)), [0.5, 0.5], 5),
    "k above union": (_seeded_maps(1, (6, 4)), [0.5, 0.5], 50),
    "three unequal weights": (_seeded_maps(2, (15, 11, 8)), [0.2, 0.5, 1.3], 12),
    "three with an empty one": (_seeded_maps(3, (10, 0, 7)), [0.6, 2.0, 0.1], 20),
}


@pytest.mark.parametrize("name", list(CASES))
def test_weighted_score_fuse_matches_jax(name):
    maps, weights, k = CASES[name]
    got = fusion.weighted_score_fuse(maps, weights, k=k)
    want = jfusion.weighted_score_fuse(maps, weights, k=k)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=1e-12)
    assert len(got) == min(k, len({i for m in maps for i in m}))


def test_weighted_score_fuse_values():
    fused = fusion.weighted_score_fuse([{"a": 10.0, "b": 8.0, "z": 0.0},
                                        {"b": 1.0, "c": 0.5}],
                                       weights=[0.5, 0.5], k=3)
    # z and c both normalize to 0; z was seen first
    assert [i for i, _ in fused] == ["b", "a", "z"]
    assert fused[0][1] == pytest.approx(0.5 * 0.8 + 0.5 * 1.0, abs=1e-12)
    # a constant map normalizes to 0 everywhere (range 1.0), not NaN
    const = fusion.weighted_score_fuse([{"a": 3.0, "b": 3.0}], [1.0], k=2)
    assert const == [("a", 0.0), ("b", 0.0)]


def test_weighted_score_fuse_is_exported():
    assert "weighted_score_fuse" in ops.__all__
    assert ops.weighted_score_fuse is fusion.weighted_score_fuse
