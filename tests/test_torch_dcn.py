"""The port's multi-process runtime (``ragmeup_tpu_torch/parallel/dcn.py``)
on the CPU: the dry run's two gloo processes (explicit
``tcp://localhost:<free port>``, a timeout each) must merge a corpus
sharded across them exactly and take the one-process decoder step's loss
and parameters; and the mesh and batch helpers on their own."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ragmeup_tpu_torch.parallel import dcn
from ragmeup_tpu_torch.parallel.mesh import make_mesh
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dcn_dryrun_two_gloo_processes():
    proc = subprocess.run(
        [sys.executable, "-m", "ragmeup_tpu_torch.tools.dcn_dryrun", "--num-slices", "2",
         "--devices-per-slice", "4", "--timeout", "240"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "dcn retrieval ok" in out
    assert "dcn train ok" in out
    assert "DCN DRYRUN PASS" in out


def test_slice_axis_must_be_data_or_corpus():
    with pytest.raises(ValueError, match="slice axis must be 'data' or 'corpus'"):
        dcn.make_multislice_mesh(slice_axis="model")


@pytest.mark.parametrize("axis", ["data", "corpus"])
def test_global_batch_takes_this_ranks_part(axis):
    local = make_mesh((1, 2, 2), devices=["cpu"] * 4)
    host = np.arange(8 * 6).reshape(8, 6)
    for rank in range(2):
        m = dcn.SliceMesh(local.devices, axis, 2, rank)
        want_shape = dict(local.shape)
        want_shape[axis] *= 2
        assert m.global_shape == want_shape
        rows = dcn.global_batch(m, {"x": host}, ("data", None))["x"]
        cols = dcn.global_batch(m, {"x": host}, (None, "corpus"))["x"]
        if axis == "data":
            assert torch.equal(rows, torch.from_numpy(host[rank * 4:(rank + 1) * 4]))
            assert torch.equal(cols, torch.from_numpy(host))
        else:
            assert torch.equal(rows, torch.from_numpy(host))
            assert torch.equal(cols, torch.from_numpy(host[:, rank * 3:(rank + 1) * 3]))
        assert torch.equal(dcn.replicated(m, host), torch.from_numpy(host))
