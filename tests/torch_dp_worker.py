"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python -m tests.torch_dp_worker SPEC RANK          # the jobs of SPEC
    python -m tests.torch_dp_worker --cli SPEC RANK    # the train CLI

SPEC is a JSON file: {"store": "file://..." or null, "world": N, "out": dir,
"jobs": [...]}, with "n_model" for a (world / n_model, n_model) grid (1 by
default), each job with its "cfg" (``dataclasses.asdict`` of a
config); with --cli, {"cfg": ..., "argv": the CLI's arguments, to which
``--process_id RANK`` is added}, and with a "name" and "out" the trained
replica's digest and step are written to ``<out>/<name>.<rank>.pt``.
With a store the rank joins a gloo group of ``world``; without one it is
the single process the group is held against.  Each job's result is
written to ``<out>/<name>.<rank>.pt`` (``<out>/<name>.alone.pt`` without a
store).  The rank runs with one torch thread
and imports nothing of JAX: the test hands it configs as dicts and tensors
as ``torch.save`` files, and reads its results back.  The helpers it
shares with chip_smoke.py's data-parallel phases (rows of a global batch,
the replica digest, the sampled-set recorder, the step loop) are
chip_smoke's.

Jobs (``kind``):

- "step": train steps from the parameters in ``state`` (the ranks after
  the first start from other ones, which the broadcast overwrites), on this
  data index's rows of the global batches in ``batches`` (and of the global
  draws in ``uniforms``, the global proposals in ``proposals``, when
  given); per step the metrics, the sampled sets and the replica's digest,
  and with ``keep_params`` the last parameters (on the first rank, put
  whole; on every rank its fc6/fc7 blocks and a digest of the replicated
  parameters); ``momentum``: the optimizer's momentum buffers to start
  from; the rank's (data index, model index);
- "trainer": ``Trainer.fit`` on this data index's rows of ``batches``, one
  checkpoint a step into ``ckpt_dir``, one ``fit`` call per batch; the
  replica's digest after each, and per ``save`` whether any operation in
  it made a tensor of the whole fc6 or fc7 weight's shape; with ``resume`` (n_data, n_model), a second
  Trainer on that grid over the same directory: whether its restored state,
  gathered whole, equals the newest checkpoint bit for bit, its fc6 block's
  shape, and how far one more step (``train_step`` on its state, no
  checkpoint) on ``batches``' first moves fc6;
- "head": the VGG-16 head of ``cfg`` from a seeded init, sharded over the
  grid, forward and backward on seeded crops, with fc6's bias gradient
  summed over the model group and without that sum; its outputs and
  gradients, and those of the whole head in this process;
- "eval": the evaluator over ``SyntheticDetection(**dataset)`` at
  ``batch_size`` with the parameters of ``state`` and ``score_thresh``;
  its detections and metrics.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import config_from_dict, digest, rows, run_steps  # noqa: E402
from trcnn_torch import parallel  # noqa: E402
from trcnn_torch.models import make_model  # noqa: E402
from trcnn_torch.parallel import tensor  # noqa: E402
from trcnn_torch.train.step import TrainState, train_step  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)


def _model(cfg, state_file: str):
    model = make_model(cfg, device="cpu")
    model.load_state_dict(torch.load(state_file))
    return model


def _head_job(cfg, mesh):
    """The "head" job (see the module docstring)."""
    from trcnn_torch.models import roi_head

    def make():
        return roi_head.VGG16RoIHead(7 * 7 * 512, cfg.num_classes, cfg.head_hidden, device="cpu")

    gen = torch.Generator().manual_seed(7)
    whole = make()
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    pooled = torch.randn((2 * 8, 7, 7, 512), generator=gen)
    g = [torch.randn((16, n), generator=gen) for n in (cfg.num_classes, 4 * cfg.num_classes)]
    rows_ = slice(8 * mesh.data_index, 8 * mesh.data_index + 8)

    def run(head):
        x = pooled[rows_].clone().requires_grad_()
        out = head(x)
        sum((o * gi[rows_]).sum() for o, gi in zip(out, g)).backward()
        return {"out": [o.detach() for o in out], "dx": x.grad,
                "grads": {k: p.grad.clone() for k, p in head.named_parameters()}}

    res = {"whole": run(whole)}
    real = roi_head.copy_to_model
    for arm in ("summed", "not summed"):
        head = make()
        head.load_state_dict(whole.state_dict())
        tensor.shard_model_(head, mesh)
        if arm == "not summed":       # fc6's bias gradient left as each rank's columns
            roi_head.copy_to_model = lambda x, grp: x if isinstance(x, torch.nn.Parameter) \
                else real(x, grp)
        try:
            res[arm] = run(head)
        finally:
            roi_head.copy_to_model = real
    return res


class _Shapes(TorchDispatchMode):
    """The shapes of every tensor that an operation makes while it is
    active (collectives and host copies included)."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def _whole_shapes(cfg) -> set:
    """The shapes of the whole fc6 and fc7 weights (torch's (out, in))."""
    return {(cfg.head_hidden, 7 * 7 * 512), (cfg.head_hidden, cfg.head_hidden)}


def run_job(job: dict, rank: int, world: int, mesh):
    cfg = config_from_dict(job["cfg"])
    kind = job["kind"]
    where = (mesh.data_index, mesh.n_data)
    if kind == "step":
        model = _model(cfg, job["state"])
        if rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        state = TrainState.create(model, mesh)
        if job.get("momentum"):
            tensor.load_whole_(model, state.optimizer, torch.load(job["state"]),
                               torch.load(job["momentum"]))
        load = {k: rows(torch.load(job[k]), *where) if job.get(k) else None
                for k in ("batches", "uniforms", "proposals")}
        res = {"steps": run_steps(state, load["batches"], load["uniforms"], load["proposals"]),
               "mesh": (mesh.data_index, mesh.model_index)}
        if job.get("keep_params"):
            kinds = tensor.param_shardings(state.model)
            whole = tensor.whole_state(state.model, state.optimizer.momentum)[0]
            res["blocks"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()
                             if kinds.get(k)}
            res["replicated"] = digest(state.model, names={k for k, v in kinds.items() if not v})
            if rank == 0:
                res["params"] = {k: v.detach().clone() for k, v in whole.items()}
        return res
    if kind == "trainer":
        from trcnn_torch.train import trainer as trainer_mod
        from trcnn_torch.train.trainer import TrainConfig, Trainer, latest_checkpoint

        batches = rows(torch.load(job["batches"]), *where)
        grid = (mesh.n_data, mesh.n_model)
        trainer_mod.make_mesh = lambda: parallel.make_mesh(*grid)
        trainer = Trainer(_model(cfg, job["state"]), cfg, TrainConfig(
            total_iters=len(batches), log_every=1, checkpoint_every=1,
            checkpoint_dir=job["ckpt_dir"]), device="cpu")
        whole = _whole_shapes(cfg)
        saves = []
        save = trainer.save

        def watched_save():
            with _Shapes() as seen:
                save()
            saves.append(bool(seen.shapes & whole))

        trainer.save = watched_save
        digests = []
        for batch in batches:
            trainer.fit([batch])
            digests.append(digest(trainer.state.model, trainer.state.optimizer.momentum))
        res = {"digests": digests, "step": trainer.state.step, "whole_in_save": saves}
        if job.get("resume"):
            n_data, n_model = job["resume"]
            trainer_mod.make_mesh = lambda: parallel.make_mesh(n_data, n_model)
            ck = torch.load(latest_checkpoint(job["ckpt_dir"])[1])
            again = Trainer(make_model(cfg, device="cpu"), cfg, TrainConfig(
                total_iters=len(batches) + 1, log_every=1, checkpoint_every=0,
                checkpoint_dir=job["ckpt_dir"]), device="cpu")
            model, momentum = again.state.model, again.state.optimizer.momentum
            sd, mom = tensor.whole_state(model, momentum)
            res["resumed"] = {
                "step": again.state.step, "mesh": again.mesh.shape,
                "fc6": tuple(model.head.fc6.weight.shape),
                "equal": all(torch.equal(sd[k], v) for k, v in ck["model"].items())
                and all(torch.equal(mom[k], v) for k, v in ck["optimizer"]["momentum"].items())}
            train_step(again.state, rows(torch.load(job["batches"]), 0, n_data)[0])
            fc6 = tensor.whole_state(model, momentum)[0]["head.fc6.weight"]
            res["resumed"]["moved"] = float((fc6 - ck["model"]["head.fc6.weight"]).abs().sum())
            res["resumed"]["step_after"] = again.state.step
        return res
    if kind == "head":
        return _head_job(cfg, mesh)
    if kind == "eval":
        from trcnn_torch.data import SyntheticDetection
        from trcnn_torch.eval import Evaluator

        model = _model(cfg, job["state"])
        tensor.shard_model_(model, mesh)
        ev = Evaluator(model, cfg, SyntheticDetection(**job["dataset"]),
                       batch_size=job["batch_size"], score_thresh=job["score_thresh"],
                       device="cpu", group=mesh.data)
        metrics = ev()
        return {"metrics": metrics, "detections": ev.detections,
                "local_images": ev.last_local_images, "batches": ev.timing["batches"]}
    raise ValueError(f"unknown job kind {kind!r}")


def main(argv: List[str]) -> int:
    torch.set_num_threads(1)
    cli = argv[0] == "--cli"
    if cli:
        argv = argv[1:]
    with open(argv[0]) as f:
        spec = json.load(f)
    rank = int(argv[1])
    if cli:
        from trcnn_torch.cli import train

        cfg = config_from_dict(spec["cfg"])
        train.make_config = lambda backbone, preset="voc": cfg.replace(backbone=backbone)
        trainer = train.run(spec["argv"] + ["--process_id", str(rank)])
        if spec.get("name"):
            torch.save({"digest": digest(trainer.state.model), "step": trainer.state.step},
                       os.path.join(spec["out"], f"{spec['name']}.{rank}.pt"))
        return 0
    mesh = parallel.Mesh()
    if spec["store"]:
        parallel.initialize(spec["store"], spec["world"], rank, backend="gloo", timeout=TIMEOUT)
        mesh = parallel.make_mesh(n_model=spec.get("n_model", 1))
    try:
        for job in spec["jobs"]:
            res = run_job(job, rank, spec["world"], mesh)
            tag = rank if spec["store"] else "alone"
            torch.save(res, os.path.join(spec["out"], f"{job['name']}.{tag}.pt"))
    finally:
        if spec["store"]:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
