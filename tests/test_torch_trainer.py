"""The port's optimizer rules and trainer on the CPU, at the tiny config.

The Caffe-order update with warmup and gradient clipping is held against
the JAX package's optax chain on identical gradients (1e-6 of each tensor's
largest magnitude: the same float32 operations); the schedule is equal to
optax's bit for bit; and a run that checkpoints after 3 steps and resumes in
a new Trainer for a 4th is bit-equal to 4 uninterrupted steps.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from trcnn.config import OptimConfig as JaxOptimConfig
from trcnn.train.optim import make_optimizer, make_schedule
from trcnn_torch.config import OptimConfig
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.entry import train_entry
from trcnn_torch.models import make_model
from trcnn_torch.train import CaffeSGD, TrainConfig, Trainer, learning_rate
from trcnn_torch.train.optim import is_frozen

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from __graft_entry__ import _tiny_cfg  # noqa: E402

OPTIM_CASES = [OptimConfig(),
               OptimConfig(warmup_steps=5, lr_decay_step=3, clip_grad_norm=0.5),
               OptimConfig(warmup_steps=100, warmup_factor=0.25, clip_grad_norm=1e3)]


@pytest.mark.parametrize("ocfg", OPTIM_CASES)
def test_schedule_equals_optax(ocfg):
    sched = make_schedule(JaxOptimConfig(**vars(ocfg)))
    for step in (0, 1, 2, 3, 4, 5, 7, 99, 100, 50000, 50001):
        assert learning_rate(ocfg, step) == float(sched(step)), step


@pytest.mark.parametrize("ocfg", OPTIM_CASES)
def test_update_equals_optax_on_identical_gradients(ocfg):
    """Two steps from a random trace; clipping, warmup and the decay as the
    case sets them; frozen parameters never move."""
    model = make_model(_tiny_cfg(), device="cpu").init(torch.Generator().manual_seed(1))
    opt = CaffeSGD(model, ocfg)
    rng = np.random.default_rng(2)
    for v in opt.momentum.values():
        v.copy_(torch.tensor(rng.standard_normal(v.shape) * 1e-3, dtype=torch.float32))
    params = state_dict_to_flax(model.state_dict())
    tx = make_optimizer(params, JaxOptimConfig(**vars(ocfg)))
    jstate = tx.init(params)
    trace4 = list(jstate)
    trace4[4] = trace4[4]._replace(trace=state_dict_to_flax(opt.momentum))
    jstate = tuple(trace4)
    frozen0 = {k: v.clone() for k, v in model.state_dict().items() if is_frozen(k)}
    for step in range(2):
        grads = {k: torch.tensor(rng.standard_normal(p.shape), dtype=torch.float32)
                 for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = None if is_frozen(k) else grads[k]
        jgrads = state_dict_to_flax({k: torch.zeros_like(g) if is_frozen(k) else g
                                     for k, g in grads.items()})
        norm = torch.stack([g.square().sum() for k, g in grads.items()
                            if not is_frozen(k)]).sum().sqrt()
        opt.step(step, norm)
        upd, jstate = tx.update(jgrads, jstate, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, upd)
        want = flax_to_state_dict(params)
        want_trace = flax_to_state_dict(jax.tree.map(np.asarray, jstate[4].trace))
        for k, p in model.state_dict().items():
            assert (p - want[k]).abs().max() <= 1e-6 * want[k].abs().max(), (step, k)
            wt = want_trace[k]
            assert (opt.momentum[k] - wt).abs().max() <= 1e-6 * wt.abs().max(), (step, k)
    for k, v in frozen0.items():
        assert torch.equal(model.state_dict()[k], v)


def _batches(cfg, n):
    """n batches of 2 uint8 canvases with train_entry's gt."""
    _, (_, batch) = train_entry("cpu", cfg=cfg, dtype=torch.float32, batch_size=2)
    gen = torch.Generator().manual_seed(5)
    out = []
    for _ in range(n):
        b = dict(batch)
        b["images"] = torch.randint(0, 256, batch["images"].shape, dtype=torch.uint8,
                                    generator=gen)
        out.append(b)
    return out


def _trainer(cfg, d, total, every, keep=5):
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    return Trainer(model, cfg, TrainConfig(total_iters=total, log_every=2, checkpoint_every=every,
                                           checkpoint_dir=str(d), keep_checkpoints=keep, seed=9),
                   device="cpu")


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, capsys):
    cfg = _tiny_cfg()                      # head dropout 0.5: the masks are drawn too
    batches = _batches(cfg, 4)
    whole = _trainer(cfg, tmp_path / "whole", 4, 1, keep=2)
    whole.fit(batches)
    assert [s for s, _ in whole.checkpoints()] == [3, 4]       # keep-N retention
    logs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in logs] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in logs)

    first = _trainer(cfg, tmp_path / "split", 3, 0)
    first.fit(batches[:3])
    assert [s for s, _ in first.checkpoints()] == [3]
    resumed = _trainer(cfg, tmp_path / "split", 4, 0)
    assert resumed.state.step == 3
    resumed.fit(batches[3:])
    assert resumed.state.step == whole.state.step == 4
    want = whole.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in resumed.state.optimizer.momentum.items():
        assert torch.equal(v, whole.state.optimizer.momentum[k]), k
