"""Training loop with checkpoints, JSON-lines logs and resume (port of
``trcnn/train/trainer.py``).

Each checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``, of {model
parameters, optimizer momentum, step}; the newest ``keep_checkpoints``
stay.  A ``Trainer`` built on a directory that holds checkpoints resumes
from the newest, and since every step's random draws derive from (seed,
step), the resumed run continues exactly as an uninterrupted one would.
The evaluator hook and the device mesh wait for later slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from trcnn_torch.config import FasterRCNNConfig
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


class Trainer:
    """Drives batches through :func:`train_step` with logs and checkpoints.

    ``model`` moves to ``device``: the card unless the caller asks for the
    CPU.  Batches are dicts of the five ``BATCH_KEYS`` tensors, on any
    device."""

    def __init__(self, model: FasterRCNN, cfg: FasterRCNNConfig,
                 tcfg: TrainConfig = TrainConfig(), device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.state = TrainState.create(model.to(self.device))
        if tcfg.checkpoint_dir:
            os.makedirs(tcfg.checkpoint_dir, exist_ok=True)
            self.maybe_restore()

    # ---- checkpoints

    def checkpoints(self) -> List[Tuple[int, str]]:
        """(step, path) of every checkpoint in the directory, oldest first."""
        d = self.tcfg.checkpoint_dir
        found = [(int(m.group(1)), os.path.join(d, f))
                 for f in os.listdir(d) if (m := _CKPT.fullmatch(f))]
        return sorted(found)

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
        for _, old in self.checkpoints()[:-self.tcfg.keep_checkpoints]:
            os.remove(old)

    def maybe_restore(self) -> bool:
        """Resume from the newest checkpoint, if there is one."""
        ckpts = self.checkpoints()
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

    def fit(self, batches: Iterable[Dict[str, torch.Tensor]]) -> TrainState:
        """Run up to ``total_iters`` steps over ``batches``; log one JSON line
        every ``log_every`` steps, checkpoint every ``checkpoint_every`` and
        at the end."""
        total = self.tcfg.total_iters or self.cfg.optim.total_iters
        st = self.state
        t0, imgs = time.time(), 0
        for batch in batches:
            if st.step >= total:
                break
            batch = {k: batch[k].to(self.device, non_blocking=True) for k in BATCH_KEYS}
            metrics = train_step(st, batch, self.tcfg.seed)
            imgs += batch["images"].shape[0]
            if st.step % self.tcfg.log_every == 0 or st.step == total:
                dt = time.time() - t0
                print(json.dumps({"step": st.step, "imgs_per_sec": round(imgs / max(dt, 1e-9), 2),
                                  **{k: round(float(v), 5) for k, v in metrics.items()}}),
                      flush=True)
                t0, imgs = time.time(), 0
            if self.tcfg.checkpoint_every and st.step % self.tcfg.checkpoint_every == 0:
                self.save()
        self.save()
        return st
