"""Multi-process dry run of ``parallel/dcn.py``: two CPU processes, one
global mesh, no card.

    python3 -m ragmeup_tpu_torch.tools.dcn_dryrun [--num-slices 2]
        [--devices-per-slice 4] [--timeout 300]

The parent picks a free localhost port and starts one child a slice
(``--process-id``), each a gloo rank of ``--devices-per-slice`` CPU
devices that joins ``tcp://localhost:<port>``; each child has its own
timeout. Across the process boundary the run proves:

1. a corpus-sharded top-k whose corpus axis spans the ranks
   (``sharded_topk_across``): the ids equal the one-process
   ``sharded_topk`` over the whole corpus and a float64 numpy oracle
   ordered by (-score, id);
2. a decoder train step with the data axis across the ranks (each rank its
   rows, 'model' 2 inside each rank): the loss and every parameter after
   the step equal the one-process step's on the whole batch (loss rtol
   1e-5; parameters atol 1e-5: AdamW's first step divides each gradient by
   its own size plus eps 1e-8, so a weight whose gradient is near eps
   moves by up to lr times the gradient's relative rounding).

Rank 0 prints ``dcn retrieval ok``, ``dcn train ok`` and ``DCN DRYRUN
PASS``; the parent exits non-zero when a child fails or times out.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _oracle_ids(q, corpus, k):
    import numpy as np
    scores = q.astype(np.float64) @ corpus.astype(np.float64).T
    return np.stack([np.lexsort((np.arange(len(row)), -row))[:k] for row in scores])


def child(args) -> None:
    import numpy as np
    import torch
    from ragmeup_tpu_torch.parallel import dcn
    from ragmeup_tpu_torch.parallel.mesh import make_mesh
    from ragmeup_tpu_torch.parallel.sharded_index import sharded_topk

    torch.set_num_threads(1)
    dcn.initialize_slice(args.coordinator, args.num_slices, args.process_id,
                         local_device_count=args.devices_per_slice)
    pid = args.process_id
    n_total = args.num_slices * args.devices_per_slice

    # -- 1. retrieval merge across the process boundary --
    mesh = dcn.make_multislice_mesh(slice_axis="corpus")
    assert mesh.global_shape == {"data": 1, "corpus": n_total, "model": 1}, mesh.global_shape
    rng = np.random.default_rng(0)  # the same data on every process
    d, n, k = 64, 128 * n_total, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.standard_normal((3, d)).astype(np.float32)
    part = dcn.global_batch(mesh, {"ct": corpus.T}, (None, "corpus"))["ct"]
    _, ids = dcn.sharded_topk_across(mesh, torch.from_numpy(q), part, k)
    one = make_mesh((1, n_total, 1), devices=["cpu"] * n_total)
    _, ids_one = sharded_topk(one, torch.from_numpy(q), torch.from_numpy(corpus.T.copy()), k)
    assert np.array_equal(ids.numpy(), ids_one.numpy()), "cross-rank top-k != one process"
    assert np.array_equal(ids.numpy(), _oracle_ids(q, corpus, k)), "cross-rank top-k != oracle"
    if pid == 0:
        print("dcn retrieval ok: corpus axis spans ranks, merge exact", flush=True)

    # -- 2. train step with dp across ranks, 'model' inside each --
    from ragmeup_tpu_torch.models.decoder import LlamaConfig
    from ragmeup_tpu_torch.parallel.tp import tp_gather_model
    from ragmeup_tpu_torch.train.train import make_decoder_train_step
    mesh_t = dcn.make_multislice_mesh(slice_axis="data", model_parallel=2)
    cfg = LlamaConfig.tiny(num_heads=4, num_kv_heads=2, dtype="float32")
    bsz = 2 * mesh_t.global_shape["data"]
    host = {"ids": rng.integers(0, cfg.vocab_size, (bsz, 16)).astype(np.int32),
            "mask": np.ones((bsz, 16), np.int32)}
    host["mask"][0, 11:] = 0  # a masked tail: the loss's count must be global
    state, step = make_decoder_train_step(cfg, mesh_t, learning_rate=1e-3, seed=0)
    state, metrics = step(state, dcn.global_batch(mesh_t, host, ("data", None)))
    ref_state, ref_step = make_decoder_train_step(cfg, learning_rate=1e-3, seed=0,
                                                  device="cpu")
    ref_state, ref_metrics = ref_step(ref_state, host)
    loss, ref_loss = float(metrics["loss"]), float(ref_metrics["loss"])
    assert np.isfinite(loss), "cross-rank train loss not finite"
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                               rtol=1e-5)
    got = tp_gather_model(state.params, cfg, mesh_t)
    for key, want in ref_state.params.items():
        np.testing.assert_allclose(got[key].detach().numpy(), want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    if pid == 0:
        print(f"dcn train ok: dp across ranks, loss={loss:.6f} "
              f"(one process {ref_loss:.6f})", flush=True)
        print("DCN DRYRUN PASS", flush=True)
    import torch.distributed
    torch.distributed.destroy_process_group()


def parent(args) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for i in range(args.num_slices):
        cmd = [sys.executable, "-m", "ragmeup_tpu_torch.tools.dcn_dryrun",
               "--process-id", str(i), "--coordinator", f"tcp://localhost:{port}",
               "--num-slices", str(args.num_slices),
               "--devices-per-slice", str(args.devices_per_slice)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO))
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=args.timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(rc != 0 for rc in rcs):
        raise SystemExit(f"dcn dry run failed: rcs={rcs}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-slices", type=int, default=2)
    ap.add_argument("--devices-per-slice", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    if args.process_id is None:
        parent(args)
    else:
        child(args)


if __name__ == "__main__":
    main()
