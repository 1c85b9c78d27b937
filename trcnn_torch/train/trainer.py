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
after the last step.  The device mesh waits for the data-parallel slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import torch

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.data.loader import Batch, upload
from trcnn_torch.models.faster_rcnn import FasterRCNN
from trcnn_torch.train.step import BATCH_KEYS, TrainState, train_step

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


@dataclasses.dataclass
class TrainConfig:
    total_iters: Optional[int] = None   # default: cfg.optim.total_iters
    log_every: int = 20
    checkpoint_every: int = 5000
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 5
    seed: int = 0
    eval_every: int = 0                 # run the evaluator every N steps (0: off)
    upload_lookahead: int = 2           # batches uploaded ahead of the step


def to_device(batch: Union[Batch, Mapping[str, torch.Tensor]], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A loader Batch (numpy) or a dict of tensors -> the five
    ``BATCH_KEYS`` tensors on ``device``; host memory goes to the card
    through pinned buffers, asynchronously."""
    if isinstance(batch, Batch):
        return {k: upload(getattr(batch, k), device) for k in BATCH_KEYS}
    out = {}
    for k in BATCH_KEYS:
        t = batch[k]
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.contiguous().pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


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
    CPU."""

    def __init__(self, model: FasterRCNN, cfg: FasterRCNNConfig,
                 tcfg: TrainConfig = TrainConfig(), device="cuda",
                 evaluator: Optional[Callable[[FasterRCNN], Dict[str, float]]] = None):
        self.device = torch.device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.evaluator = evaluator
        self.state = TrainState.create(model.to(self.device))
        if tcfg.checkpoint_dir:
            os.makedirs(tcfg.checkpoint_dir, exist_ok=True)
            self.maybe_restore()

    # ---- checkpoints

    def save(self) -> None:
        if not self.tcfg.checkpoint_dir:
            return
        st = self.state
        path = os.path.join(self.tcfg.checkpoint_dir, f"ckpt_{st.step:08d}.pt")
        if os.path.exists(path):                # this step is saved already
            return
        torch.save({"model": st.model.state_dict(), "optimizer": st.optimizer.state_dict(),
                    "step": st.step}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in checkpoints(self.tcfg.checkpoint_dir)[:-self.tcfg.keep_checkpoints]:
            os.remove(old)

    def maybe_restore(self) -> bool:
        """Resume from the newest checkpoint, if there is one."""
        ckpts = checkpoints(self.tcfg.checkpoint_dir)
        if not ckpts:
            return False
        step, path = ckpts[-1]
        ck = torch.load(path, map_location=self.device)
        self.state.model.load_state_dict(ck["model"])
        self.state.optimizer.load_state_dict(ck["optimizer"])
        self.state.step = ck["step"]
        print(f"[trainer] resumed from checkpoint at step {step}", flush=True)
        return True

    # ---- loop

    def fit(self, batches: Iterable) -> TrainState:
        """Run up to ``total_iters`` steps over ``batches``; log one JSON line
        every ``log_every`` steps, checkpoint every ``checkpoint_every`` and
        at the end, evaluate every ``eval_every`` steps and after the last
        one."""
        tcfg = self.tcfg
        total = tcfg.total_iters or self.cfg.optim.total_iters
        st = self.state
        t0, imgs = time.time(), 0
        it = iter(batches)
        window: List[Dict[str, torch.Tensor]] = []

        def enqueue() -> None:
            nxt = next(it, None)
            if nxt is not None:
                window.append(to_device(nxt, self.device))

        for _ in range(max(1, tcfg.upload_lookahead)):
            enqueue()
        while window and st.step < total:
            batch = window.pop(0)
            enqueue()
            metrics = train_step(st, batch, tcfg.seed)
            imgs += batch["images"].shape[0]
            if st.step % tcfg.log_every == 0 or st.step == total:
                dt = time.time() - t0
                print(json.dumps({"step": st.step, "imgs_per_sec": round(imgs / max(dt, 1e-9), 2),
                                  **{k: round(float(v), 5) for k, v in metrics.items()}}),
                      flush=True)
                t0, imgs = time.time(), 0
            if tcfg.checkpoint_every and st.step % tcfg.checkpoint_every == 0:
                self.save()
            if self.evaluator is not None and tcfg.eval_every and (
                    st.step % tcfg.eval_every == 0 or st.step == total):
                self.run_eval(st.step)
                t0, imgs = time.time(), 0         # eval time is not training time
        self.save()
        if self.evaluator is not None and tcfg.eval_every:
            if st.step % tcfg.eval_every and st.step != total:
                self.run_eval(st.step)
        return st

    def run_eval(self, step: int) -> Dict[str, float]:
        """Evaluate the current model; print the scalars without a class in
        their name as one JSON line."""
        results = {k: float(v) for k, v in self.evaluator(self.state.model).items()}
        print(json.dumps({"step": step, **{k: round(v, 4) for k, v in results.items()
                                           if "/" not in k}}), flush=True)
        return results
