"""K optimizer steps per call (``train_steps``), the trainer's hooks and
metric writer, and the train CLI's ``--no_writer``, on the CPU at the tiny
config.

- ``train_steps`` with K=2 and K=3 (the twin of tests/test_train.py::
  test_train_step_inner_steps_matches_sequential) equals K sequential
  ``train_step`` calls bit for bit: parameters, momentum, step and the last
  step's metrics;
- ``Trainer.fit(..., hooks=)`` runs each hook once, at its step, after that
  step's checkpoint and evaluation; ``TrainConfig.metric_writer`` gets every
  log step's metrics and every scalar of each evaluation, per-class APs
  included (the evaluator is a stub: what it returns, not how, is under
  test);
- the train CLI makes a writer under ``<out>/tb`` unless ``--no_writer``,
  and says so and goes on when none can be made.
"""

import os

import pytest
import torch

from trcnn_torch.cli import train
from trcnn_torch.entry import tiny_config
from trcnn_torch.models import make_model
from trcnn_torch.train import TrainConfig, Trainer, TrainState, train_step, train_steps
from trcnn_torch.train.step import BATCH_KEYS
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)
from tests.test_torch_parallel import _batches


def _state():
    return TrainState.create(make_model(tiny_config(), device="cpu").init(
        torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("k", [2, 3])
def test_train_steps_equals_sequential_steps(k):
    """One call of K steps on K stacked batches against K calls of
    ``train_step`` on the same batches, from the same state (dropout on: the
    masks are drawn from each step's generator)."""
    batches = _batches(tiny_config(), k)
    seq = _state()
    for b in batches:
        want = train_step(seq, b, seed=4)
    one = _state()
    got = train_steps(one, {key: torch.stack([b[key] for b in batches]) for key in BATCH_KEYS},
                      seed=4)
    assert one.step == seq.step == k
    assert got.keys() == want.keys()
    for key, v in want.items():
        assert torch.equal(got[key], v), key
    assert want["num_fg_rois"] > 0
    ref = seq.model.state_dict()
    for key, v in one.model.state_dict().items():
        assert torch.equal(v, ref[key]), key
    for key, v in one.optimizer.momentum.items():
        assert torch.equal(v, seq.optimizer.momentum[key]), key
    with pytest.raises(ValueError, match="leading K axis"):
        train_steps(one, {key: torch.stack([batches[0][key]] * (2 if key == "images" else 1))
                          for key in BATCH_KEYS})


class Recorder:
    """A metric writer that keeps what it is given, in ``events``."""

    def __init__(self, events):
        self.events = events

    def write_scalars(self, step, scalars):
        self.events.append(("write", step, dict(scalars)))

    def flush(self):
        self.events.append(("flush",))


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """3 steps: a log every step, a checkpoint and the stub evaluator every
    2 steps (and after the last), hooks at steps 1, 2 and 5 (never
    reached); every call in order in ``events``."""
    d = tmp_path_factory.mktemp("hooks")
    cfg = tiny_config()
    events = []

    def evaluator(model):
        events.append(("eval", len(events)))
        return {"eval_mAP": 0.25, "eval_AP/dog": 0.5, "eval_AP/cat": 0.0, "eval_images": 2.0}

    def hook(trainer):
        events.append(("hook", trainer.state.step, sorted(os.listdir(d))))

    t = Trainer(make_model(cfg, device="cpu").init(torch.Generator().manual_seed(3)), cfg,
                TrainConfig(total_iters=3, log_every=1, checkpoint_every=2,
                            checkpoint_dir=str(d), eval_every=2,
                            metric_writer=Recorder(events)),
                device="cpu", evaluator=evaluator)
    t.fit(_batches(cfg, 3), hooks={1: hook, 2: hook, 5: hook})
    return events


def test_hooks_run_once_after_the_checkpoint_and_evaluation(fitted):
    hooks = [e for e in fitted if e[0] == "hook"]
    assert [h[1] for h in hooks] == [1, 2]
    assert hooks[0][2] == [] and hooks[1][2] == ["ckpt_00000002.pt"]
    kinds = [e[0] if e[0] != "write" else ("eval scalars" if "eval_mAP" in e[2] else "log")
             for e in fitted]
    assert kinds == ["log", "hook", "log", "eval", "eval scalars", "hook", "log", "eval",
                     "eval scalars"]


def test_metric_writer_gets_the_logs_and_every_eval_scalar(fitted):
    writes = [e for e in fitted if e[0] == "write"]
    logs = [(s, v) for _, s, v in writes if "loss" in v]
    assert [s for s, _ in logs] == [1, 2, 3]
    assert all({"loss", "grad_norm", "num_fg_rois"} <= v.keys() for _, v in logs)
    assert all(isinstance(x, float) for _, v in logs for x in v.values())
    evals = [(s, v) for _, s, v in writes if "eval_mAP" in v]
    assert [s for s, _ in evals] == [2, 3]
    assert evals[0][1] == {"eval_mAP": 0.25, "eval_AP/dog": 0.5, "eval_AP/cat": 0.0,
                           "eval_images": 2.0}


def test_train_cli_writer_and_no_writer(tmp_path, monkeypatch, capsys):
    """With ``--out``: one writer under <out>/tb, handed every log step;
    with ``--no_writer``: none made; a writer that cannot be made: the JAX
    script's line, and training goes on."""
    monkeypatch.setattr(train, "make_config", lambda backbone, preset="voc": tiny_config())
    made = []

    def make_writer(logdir):
        made.append(logdir)
        return Recorder([])

    monkeypatch.setattr(train, "make_writer", make_writer)
    argv = ["--dataset", "synthetic", "--iters", "1", "--batch_size", "1", "--log_every", "1",
            "--device", "cpu"]
    trainer = train.run(argv + ["--out", str(tmp_path / "a")])
    assert made == [f"{tmp_path / 'a'}/tb"]
    assert [e[:2] for e in trainer.tcfg.metric_writer.events] == [("write", 1), ("flush",)]
    trainer = train.run(argv + ["--out", str(tmp_path / "b"), "--no_writer"])
    assert len(made) == 1 and trainer.tcfg.metric_writer is None
    assert os.listdir(tmp_path / "b") == ["ckpt_00000001.pt"]

    monkeypatch.undo()

    def broken(logdir):
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(train, "TensorBoardWriter", broken)
    capsys.readouterr()
    assert train.make_writer(str(tmp_path / "tb")) is None
    assert ("metric writer unavailable (No module named 'tensorboard'); stdout JSON-lines only"
            in capsys.readouterr().out)
