"""The train CLI as two processes with ``--no_mesh``, over gloo on the CPU:
each process trains alone on its loader shard, and only process 0 of the
group logs and writes the checkpoint, as the JAX trainer gates on
``jax.process_index() == 0`` whatever the mesh.

The two processes are ``tests/torch_dp_worker.py --cli`` (one torch thread
each, a ``file://`` store under the test's temporary directory, a timeout
on the join, killed in a ``finally``), on ``__graft_entry__._tiny_cfg``.
"""

import dataclasses
import json
import os

import torch

from __graft_entry__ import _tiny_cfg
from chip_smoke import digest
from tests.test_torch_parallel import WORLD, _join, _launch, _load, _port_cfg
from trcnn_torch.models import make_model
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)


def test_train_cli_no_mesh_leaves_the_checkpoint_to_process_zero(tmp_path):
    """One step at a global batch of 2: the two replicas differ (no
    gradient exchange), process 1 prints no log line, and the one
    checkpoint holds process 0's replica."""
    cfg = _port_cfg(_tiny_cfg())
    out = str(tmp_path)
    spec = {"cfg": dataclasses.asdict(cfg), "name": "nomesh", "out": out, "argv": [
        "--dataset", "synthetic", "--iters", "1", "--batch_size", "2", "--log_every", "1",
        "--out", f"{out}/ckpt", "--no_writer", "--device", "cpu", "--coordinator", f"file://{out}/store",
        "--num_processes", str(WORLD), "--no_mesh"]}
    _join([_launch(f"{out}/nomesh.json", spec, range(WORLD), cli=True)])
    ranks = [_load(out, "nomesh", r) for r in range(WORLD)]
    assert [r["step"] for r in ranks] == [1, 1] and ranks[0]["digest"] != ranks[1]["digest"]
    first, second = (open(f"{out}/nomesh.json.{r}.log").read() for r in range(WORLD))
    assert [json.loads(x)["step"] for x in first.splitlines() if x.startswith("{")] == [1]
    assert "training done" in first
    assert not any(x.startswith("{") or "training done" in x or "resumed" in x
                   for x in second.splitlines())
    assert os.listdir(f"{out}/ckpt") == ["ckpt_00000001.pt"]
    model = make_model(cfg, device="cpu")
    model.load_state_dict(torch.load(f"{out}/ckpt/ckpt_00000001.pt")["model"])
    assert digest(model) == ranks[0]["digest"]
