"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python -m tests.torch_dp_worker SPEC RANK          # the jobs of SPEC
    python -m tests.torch_dp_worker --cli SPEC RANK    # the train CLI

SPEC is a JSON file: {"store": "file://..." or null, "world": N, "out": dir,
"jobs": [...]}, each job with its "cfg" (``dataclasses.asdict`` of a
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
  the first start from other ones, which the broadcast overwrites), on this rank's
  rows of the global batches in ``batches`` (and of the global draws in
  ``uniforms``, the global proposals in ``proposals``, when given); per
  step the metrics, the sampled sets and the replica's digest, and with
  ``keep_params`` the last parameters; ``momentum``: the optimizer's
  momentum buffers to start from;
- "trainer": ``Trainer.fit`` on this rank's rows of ``batches``, one
  checkpoint a step into ``ckpt_dir``, one ``fit`` call per batch; the
  replica's digest after each;
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import config_from_dict, digest, rows, run_steps  # noqa: E402
from trcnn_torch import parallel  # noqa: E402
from trcnn_torch.models import make_model  # noqa: E402
from trcnn_torch.train.step import TrainState  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)


def _model(cfg, state_file: str):
    model = make_model(cfg, device="cpu")
    model.load_state_dict(torch.load(state_file))
    return model


def run_job(job: dict, rank: int, world: int, group):
    cfg = config_from_dict(job["cfg"])
    kind = job["kind"]
    if kind == "step":
        model = _model(cfg, job["state"])
        if rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        state = TrainState.create(model, group)
        if job.get("momentum"):
            state.optimizer.load_state_dict({"momentum": torch.load(job["momentum"])})
        load = {k: rows(torch.load(job[k]), rank, world) if job.get(k) else None
                for k in ("batches", "uniforms", "proposals")}
        res = {"steps": run_steps(state, load["batches"], load["uniforms"], load["proposals"])}
        if job.get("keep_params"):
            res["params"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        return res
    if kind == "trainer":
        from trcnn_torch.train.trainer import TrainConfig, Trainer

        batches = rows(torch.load(job["batches"]), rank, world)
        trainer = Trainer(_model(cfg, job["state"]), cfg, TrainConfig(
            total_iters=len(batches), log_every=1, checkpoint_every=1,
            checkpoint_dir=job["ckpt_dir"]), device="cpu")
        digests = []
        for batch in batches:
            trainer.fit([batch])
            digests.append(digest(trainer.state.model, trainer.state.optimizer.momentum))
        return {"digests": digests, "step": trainer.state.step}
    if kind == "eval":
        from trcnn_torch.data import SyntheticDetection
        from trcnn_torch.eval import Evaluator

        ev = Evaluator(_model(cfg, job["state"]), cfg, SyntheticDetection(**job["dataset"]),
                       batch_size=job["batch_size"], score_thresh=job["score_thresh"],
                       device="cpu", group=group)
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
    group = None
    if spec["store"]:
        parallel.initialize(spec["store"], spec["world"], rank, backend="gloo", timeout=TIMEOUT)
        group = torch.distributed.group.WORLD
    try:
        for job in spec["jobs"]:
            res = run_job(job, rank, spec["world"], group)
            tag = rank if group is not None else "alone"
            torch.save(res, os.path.join(spec["out"], f"{job['name']}.{tag}.pt"))
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
