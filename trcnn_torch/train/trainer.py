"""Training loop with checkpoints, JSON-lines logs and resume (port of
``trcnn/train/trainer.py``).

Each checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``, of {model
parameters, optimizer momentum, step}; the newest ``keep_checkpoints``
stay.  A ``Trainer`` built on a directory that holds checkpoints resumes
from the newest, and since every step's random draws derive from (seed,
step), the resumed run continues exactly as an uninterrupted one would.

Batches are the loader's :class:`~trcnn_torch.data.loader.Batch` (numpy)
or dicts of the five ``BATCH_KEYS`` tensors.  Host batches go to the
device from pinned memory ``upload_lookahead`` batches ahead of the step
that takes them, so that the copies overlap the steps before.  An
``evaluator`` (``model -> {metric: float}``, e.g.
:class:`trcnn_torch.eval.Evaluator`) runs every ``eval_every`` steps and
after the last step.  ``TrainConfig.metric_writer`` (any object with
``write_scalars(step, {name: float})``, e.g. the train CLI's TensorBoard
writer) takes each log step's metrics and every scalar of each evaluation,
the per-class APs included; ``fit``'s ``hooks`` ({step: callable}) run
with the trainer after that step's log, checkpoint and evaluation.

Data parallel (``TrainConfig.use_mesh``, the default, once
:func:`trcnn_torch.parallel.initialize` has made a process group): the step
runs over the grid of the module-level :func:`make_mesh` (every rank on
``data`` unless it is replaced, as the JAX trainer's is in its tests),
each process feeding its data index's loader shard, and ``imgs_per_sec``
counts the global batch.  Only the first rank logs and writes
checkpoints; the others wait for the file at a barrier.  A checkpoint
holds the one-process state (fc6/fc7 and their traces gathered whole on
the first rank alone, through host memory), and every rank restores it onto
its own device and slices it for its grid, so a run resumes on any grid
and at any world size.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from trcnn_torch import parallel
from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.models.faster_rcnn import FasterRCNN
from trcnn_torch.parallel import make_mesh
from trcnn_torch.parallel.tensor import checkpoint_state, load_whole_
from trcnn_torch.train.step import TrainState, device_batch, train_step

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


@dataclasses.dataclass
class TrainConfig:
    total_iters: Optional[int] = None   # default: cfg.optim.total_iters
    log_every: int = 20
    checkpoint_every: int = 5000
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 5
    seed: int = 0
    use_mesh: bool = True               # data parallel over the process group, if one exists
    metric_writer: Optional[Any] = None  # anything with write_scalars(step, {name: float})
    eval_every: int = 0                 # run the evaluator every N steps (0: off)
    upload_lookahead: int = 2           # batches uploaded ahead of the step


def checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(step, path) of every ``ckpt_<step>.pt`` in ``directory``, oldest
    first."""
    found = [(int(m.group(1)), os.path.join(directory, f))
             for f in os.listdir(directory) if (m := _CKPT.fullmatch(f))]
    return sorted(found)


def latest_checkpoint(directory: str) -> Tuple[int, str]:
    """(step, path) of the newest checkpoint in ``directory``."""
    found = checkpoints(directory)
    if not found:
        raise FileNotFoundError(f"no ckpt_<step>.pt in {directory}")
    return found[-1]


class Trainer:
    """Drives batches through :func:`train_step` with logs, checkpoints and
    the evaluator hook.

    ``model`` moves to ``device``: the card unless the caller asks for the
    CPU (data parallel: the rank's device, from ``initialize``).  ``mesh``
    is the (data, model) grid: :func:`make_mesh`'s when ``tcfg.use_mesh``
    and a process group exists, else 1 x 1 (one process); ``group`` its
    data group."""

    def __init__(self, model: FasterRCNN, cfg: FasterRCNNConfig,
                 tcfg: TrainConfig = TrainConfig(), device="cuda",
                 evaluator: Optional[Callable[[FasterRCNN], Dict[str, float]]] = None):
        self.device = torch.device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.evaluator = evaluator
        use = tcfg.use_mesh and dist.is_initialized()
        self.mesh = make_mesh() if use else parallel.Mesh()
        self.group = self.mesh.data
        self.state = TrainState.create(model.to(self.device), self.mesh)
        if tcfg.checkpoint_dir:
            os.makedirs(tcfg.checkpoint_dir, exist_ok=True)
            self.maybe_restore()

    # ---- checkpoints

    def _main(self) -> bool:
        """The process that logs and writes checkpoints: rank 0 of the
        default group, whatever the trainer's group (under ``use_mesh=False``
        every process trains alone, but they share the checkpoint
        directory)."""
        return parallel.is_main_process()

    def save(self) -> None:
        """Write ``ckpt_<step>.pt`` (the first rank, which alone gathers
        fc6/fc7 and their momentum whole: :func:`checkpoint_state`; the
        others wait for it)."""
        if not self.tcfg.checkpoint_dir:
            return
        st = self.state
        path = os.path.join(self.tcfg.checkpoint_dir, f"ckpt_{st.step:08d}.pt")
        whole = checkpoint_state(st.model, st.optimizer.momentum)
        if self._main() and not os.path.exists(path):   # else this step is saved already
            model, momentum = whole
            torch.save({"model": model, "optimizer": {"momentum": momentum}, "step": st.step},
                       path + ".tmp")
            os.replace(path + ".tmp", path)
            for _, old in checkpoints(self.tcfg.checkpoint_dir)[:-self.tcfg.keep_checkpoints]:
                os.remove(old)
        parallel.barrier(dist.group.WORLD if dist.is_initialized() else None)

    def maybe_restore(self) -> bool:
        """Resume from the newest checkpoint, if there is one, sliced for
        this rank's grid."""
        ckpts = checkpoints(self.tcfg.checkpoint_dir)
        if not ckpts:
            return False
        step, path = ckpts[-1]
        ck = torch.load(path, map_location=self.device)
        load_whole_(self.state.model, self.state.optimizer, ck["model"],
                    ck["optimizer"]["momentum"])
        self.state.step = ck["step"]
        if self._main():
            print(f"[trainer] resumed from checkpoint at step {step}", flush=True)
        return True

    # ---- loop

    def fit(self, batches: Iterable,
            hooks: Optional[Dict[int, Callable[["Trainer"], Any]]] = None) -> TrainState:
        """Run up to ``total_iters`` steps over ``batches``; log one JSON line
        every ``log_every`` steps (and hand the metrics to the metric
        writer), checkpoint every ``checkpoint_every`` and at the end,
        evaluate every ``eval_every`` steps and after the last one, and
        after all of that call ``hooks[step](self)`` for a step in
        ``hooks``.  Data parallel, ``batches`` are this rank's shards."""
        tcfg = self.tcfg
        total = tcfg.total_iters or self.cfg.optim.total_iters
        st = self.state
        t0, imgs = time.time(), 0
        it = iter(batches)
        window: List[Dict[str, torch.Tensor]] = []

        def enqueue() -> None:
            nxt = next(it, None)
            if nxt is not None:
                window.append(device_batch(nxt, self.device))

        for _ in range(max(1, tcfg.upload_lookahead)):
            enqueue()
        while window and st.step < total:
            batch = window.pop(0)
            enqueue()
            metrics = train_step(st, batch, tcfg.seed)
            imgs += batch["images"].shape[0] * self.mesh.n_data
            if st.step % tcfg.log_every == 0 or st.step == total:
                # read back only where something takes it
                values = ({k: float(v) for k, v in metrics.items()}
                          if self._main() or tcfg.metric_writer is not None else {})
                if self._main():
                    dt = time.time() - t0
                    print(json.dumps({"step": st.step,
                                      "imgs_per_sec": round(imgs / max(dt, 1e-9), 2),
                                      **{k: round(v, 5) for k, v in values.items()}}), flush=True)
                if tcfg.metric_writer is not None:
                    tcfg.metric_writer.write_scalars(st.step, values)
                t0, imgs = time.time(), 0
            if tcfg.checkpoint_every and st.step % tcfg.checkpoint_every == 0:
                self.save()
            if self.evaluator is not None and tcfg.eval_every and (
                    st.step % tcfg.eval_every == 0 or st.step == total):
                self.run_eval(st.step)
                t0, imgs = time.time(), 0         # eval time is not training time
            if hooks and st.step in hooks:
                hooks[st.step](self)
        self.save()
        if self.evaluator is not None and tcfg.eval_every:
            if st.step % tcfg.eval_every and st.step != total:
                self.run_eval(st.step)
        return st

    def run_eval(self, step: int) -> Dict[str, float]:
        """Evaluate the current model (every rank: the evaluator gathers over
        the group); the first rank prints the scalars without a class in
        their name as one JSON line and hands every scalar, the per-class
        APs included, to the metric writer."""
        results = {k: float(v) for k, v in self.evaluator(self.state.model).items()}
        if self._main():
            print(json.dumps({"step": step, **{k: round(v, 4) for k, v in results.items()
                                               if "/" not in k}}), flush=True)
            if self.tcfg.metric_writer is not None:
                self.tcfg.metric_writer.write_scalars(step, results)
        return results
