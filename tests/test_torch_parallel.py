"""The port's data parallelism on the CPU: ``trcnn_torch.parallel``, the
data-parallel train step, the trainer's checkpoints across world sizes,
the sharded evaluator and the train CLI's multi-process flags, over gloo.

Two ranks run as processes (``tests/torch_dp_worker.py``, one torch thread
each, a ``file://`` store under the test's temporary directory, a timeout
on the group and on every join, killed in a ``finally``); a third process
with the same thread count runs the same jobs without a group, on the whole
global batch: world size 1; two more run the train CLI.  One launch of
each serves every test below, and a second pair of ranks takes JAX's
inputs once this process has made them; the JAX mesh step compiles here
meanwhile.

Tolerances, world 2 against world 1 on the same global batch, float32:
losses and grad_norm within 1e-5 relative (the ranks' shares are summed
in another order than one process sums the batch; measured about 1e-7),
the parameters after two steps within 1e-5 of each tensor's largest
magnitude; sampled sets (anchor labels, RoI labels and valid slots) equal
and the sampled RoI boxes within 1e-2 pixel (oneDNN's convolutions at one
image and at two differ in the last bits, and the second step starts from
parameters summed in another order: measured 1e-5 pixel on VGG-16, 3.3e-3
on ResNet-101 at its second step); the replicas bit-identical after every
step, the second rank's own initial weights overwritten by the broadcast.  Against JAX's ``make_train_step`` on a
two-device ``make_mesh`` (conftest's 8 host devices), with JAX's draws
handed in, on tests/test_torch_train.py's inputs: its tolerances (losses
1e-4 relative, counts equal, grad_norm 1e-3, the parameters after the step
within 1e-5 of each tensor's largest magnitude).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from tests.test_cross_impl_train import _derive_uniforms, _geom, _sampling_rng
from tests.torch_shared import vgg_train_fixture
from tests.test_torch_package import REPO
from tests.test_torch_resnet_train import _cfg as _r101_cfg
from tests.test_torch_train import _jax_state
from trcnn.config import ProposalTargetConfig
from trcnn.train.optim import make_optimizer
from trcnn.train.step import make_mesh, make_train_step
from trcnn_torch import parallel
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.entry import TRAIN_GT_BOXES, TRAIN_GT_LABELS
from trcnn_torch.models import make_model
from trcnn_torch.models.faster_rcnn import UNIFORM_KEYS
from trcnn_torch.train.trainer import TrainConfig, Trainer
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

WORLD = 2
RTOL = 1e-5
ROI_ATOL = 1e-2
JOIN_S = 300
LOSSES = ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss")


def _port_cfg(jcfg):
    return _cfg_from_dict(dataclasses.asdict(jcfg))


def _cfg_from_dict(d):
    from chip_smoke import config_from_dict

    return config_from_dict(d)


def _batches(cfg, n, b=2, seed=5):
    """n global batches of b uint8 canvases with train_entry's gt, scaled
    into the canvas."""
    h, w = cfg.image.pad_h, cfg.image.pad_w
    scale = min(1.0, (h - 4) / 600.0, (w - 4) / 1000.0)
    g = len(TRAIN_GT_LABELS)
    gen = torch.Generator().manual_seed(seed)
    return [{"images": torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, generator=gen),
             "im_info": torch.tensor([[h - 4.0, w - 4.0, 1.0]]).expand(b, 3).contiguous(),
             "gt_boxes": (torch.tensor(TRAIN_GT_BOXES) * scale).expand(b, g, 4).contiguous(),
             "gt_labels": torch.tensor(TRAIN_GT_LABELS, dtype=torch.int32).expand(b, g)
             .contiguous(),
             "gt_valid": torch.ones((b, g), dtype=torch.bool)} for _ in range(n)]


def _r101_model(cfg):
    """Seeded ResNet-101 with live residual branches and random FrozenBN
    leaves (chip_smoke.wake_residuals, as the JAX fixture does)."""
    from chip_smoke import wake_residuals

    gen = torch.Generator().manual_seed(21)
    model = make_model(cfg, device="cpu").init(gen)
    wake_residuals(model, gen)
    return model


def _launch(path, spec, ranks, cli=False):
    """Start ``ranks`` workers on ``spec`` (written to ``path``)."""
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for r in ranks:
        with open(f"{path}.{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dp_worker", *(["--cli"] * cli), path, str(r)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return path, procs


def _join(launches, timeout=JOIN_S):
    """Wait for every worker (one deadline for all), kill what is left in
    any case, and fail with the logs of those that did not exit 0."""
    deadline = time.monotonic() + timeout
    try:
        for _, procs in launches:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for _, procs in launches:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
    bad = []
    for path, procs in launches:
        for r, p in enumerate(procs):
            if p.returncode != 0:
                bad.append(f"--- {path} worker {r}: exit {p.returncode}\n"
                           + open(f"{path}.{r}.log").read()[-3000:])
    assert not bad, "\n".join(bad)


def _load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}.{rank}.pt"), weights_only=False)


def _xtrain(out, tmp_path_factory):
    """tests/test_torch_train.py's inputs: tests/test_cross_impl_train.py's
    fixture (config without dropout, JAX-initialised weights, images, gt),
    a random momentum trace, and JAX's draws for step 0 of key 11."""
    jcfg, jmodel, params, images, im_info, (gtb, gtl, gtv) = vgg_train_fixture(tmp_path_factory)
    rng = np.random.default_rng(0)
    trace = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
                         params)
    key = jax.random.PRNGKey(11)
    _, samp = jax.random.split(jax.random.fold_in(key, 0))
    fh, fw, n, n_cand = _geom(jcfg)
    _, _, uni = _derive_uniforms(_sampling_rng(jmodel, params, samp), 2, n, n_cand)
    uniforms = {k: torch.from_numpy(np.stack([u[k] for u in uni])) for k in UNIFORM_KEYS}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in zip(
        ("images", "im_info", "gt_boxes", "gt_labels", "gt_valid"),
        (images, im_info, gtb, gtl, gtv))}
    torch.save(flax_to_state_dict(params), f"{out}/xtrain_state.pt")
    torch.save(flax_to_state_dict(trace), f"{out}/xtrain_momentum.pt")
    torch.save([batch], f"{out}/xtrain_batches.pt")
    torch.save([uniforms], f"{out}/xtrain_uniforms.pt")
    return jcfg, jmodel, params, trace, batch, key


def _unequal(cfg, out):
    """One global batch of the tiny config whose second image has no gt
    and, handed in, no valid proposal: every one of its slots is invalid,
    so the ranks' valid-slot counts differ (16 and 0).  Its draws are
    handed in too."""
    (batch,) = _batches(cfg, 1, seed=8)
    batch["gt_valid"][1] = False
    p = cfg.proposals.post_nms_topk_train
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 50, (2, p, 2))
    wh = rng.uniform(8, 40, (2, p, 2))
    rois = torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, 90)], -1).astype(np.float32))
    valid = torch.tensor([[True] * p, [False] * p])
    n = (cfg.image.pad_h // 16) * (cfg.image.pad_w // 16) * cfg.anchors.num_anchors
    gen = torch.Generator().manual_seed(9)
    uniforms = {k: torch.rand((2, n if k.startswith("at") else p + batch["gt_boxes"].shape[1]),
                              generator=gen) for k in UNIFORM_KEYS}
    torch.save([batch], f"{out}/unequal_batches.pt")
    torch.save([(rois, valid)], f"{out}/unequal_proposals.pt")
    torch.save([uniforms], f"{out}/unequal_uniforms.pt")


EVAL_SET = {"n": 7, "num_classes": 21, "hw_range": [[200, 400], [200, 400]], "seed": 1}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every multi-process job of this file: two gloo ranks, one process
    at world size 1 and two ranks of the train CLI, launched together, then
    two ranks on JAX's inputs, and JAX's mesh step meanwhile.  Returns the
    results."""
    out = str(tmp_path_factory.mktemp("dp"))
    vgg = _port_cfg(_tiny_cfg())
    r101 = _port_cfg(_r101_cfg().replace(proposal_targets=ProposalTargetConfig(rois_per_image=8)))
    torch.save(make_model(vgg, device="cpu").init(torch.Generator().manual_seed(3)).state_dict(),
               f"{out}/vgg_state.pt")
    torch.save(_r101_model(r101).state_dict(), f"{out}/r101_state.pt")
    torch.save(_batches(vgg, 2), f"{out}/vgg_batches.pt")
    torch.save(_batches(r101, 2, seed=6), f"{out}/r101_batches.pt")
    _unequal(vgg, out)

    def job(name, kind, cfg, state, **kw):
        return {"name": name, "kind": kind, "cfg": dataclasses.asdict(cfg),
                "state": f"{out}/{state}_state.pt", **kw}

    common = [job("vgg", "step", vgg, "vgg", batches=f"{out}/vgg_batches.pt", keep_params=True),
              job("unequal", "step", vgg, "vgg", batches=f"{out}/unequal_batches.pt",
                  uniforms=f"{out}/unequal_uniforms.pt", proposals=f"{out}/unequal_proposals.pt"),
              job("r101", "step", r101, "r101", batches=f"{out}/r101_batches.pt"),
              job("eval", "eval", vgg, "vgg", dataset=EVAL_SET, score_thresh=0.0)]
    ranked = [dict(j) for j in common] + [
        job("trainer", "trainer", vgg, "vgg", batches=f"{out}/vgg_batches.pt",
            ckpt_dir=f"{out}/ckpt")]
    ranked[3]["batch_size"] = 4
    alone = [dict(j) for j in common]
    alone[3]["batch_size"] = 2
    cli_out = f"{out}/cli"
    cli = {"cfg": dataclasses.asdict(vgg), "argv": [
        "--dataset", "synthetic", "--iters", "1", "--batch_size", "2", "--log_every", "1",
        "--eval_every", "1", "--eval_limit", "3", "--eval_synthetic_n", "3", "--out", cli_out, "--no_writer",
        "--device", "cpu", "--coordinator", f"file://{out}/cli_store", "--num_processes", "2"]}
    launches = [
        _launch(f"{out}/alone.json", {"store": None, "world": 1, "out": out, "jobs": alone}, [0]),
        _launch(f"{out}/ranks.json", {"store": f"file://{out}/store", "world": WORLD,
                                      "out": out, "jobs": ranked}, range(WORLD)),
        _launch(f"{out}/cli.json", cli, range(WORLD), cli=True)]
    try:
        xjcfg, jmodel, params, trace, xbatch, key = _xtrain(out, tmp_path_factory)
        xjob = job("xtrain", "step", _port_cfg(xjcfg), "xtrain",
                   batches=f"{out}/xtrain_batches.pt", uniforms=f"{out}/xtrain_uniforms.pt",
                   momentum=f"{out}/xtrain_momentum.pt", keep_params=True)
        launches.append(_launch(f"{out}/xranks.json", {
            "store": f"file://{out}/xstore", "world": WORLD, "out": out, "jobs": [xjob]},
            range(WORLD)))
        # JAX's step on a (data=2, model=1) mesh: the state replicated, the
        # batch's rows on two devices
        tx = make_optimizer(params, xjcfg.optim)
        mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
        sharding = jax.sharding.NamedSharding
        jstate = jax.device_put(_jax_state(params, tx, trace, 0),
                                sharding(mesh, jax.sharding.PartitionSpec()))
        jbatch = {k: jax.device_put(v.numpy(), sharding(mesh, jax.sharding.PartitionSpec("data")))
                  for k, v in xbatch.items()}
        jnew, jmetrics = make_train_step(jmodel, tx, mesh, donate=False)(jstate, jbatch, key)
        jax_res = {"metrics": {k: float(v) for k, v in jmetrics.items()},
                   "params": {k: v.numpy() for k, v in
                              flax_to_state_dict(jax.tree.map(np.asarray, jnew.params)).items()}}
    finally:
        _join(launches)
    res = {name: [_load(out, name, r) for r in range(WORLD)]
           for name in ("vgg", "unequal", "eval", "trainer", "xtrain", "r101")}
    res.update({f"{name}_alone": _load(out, name, "alone")
                for name in ("vgg", "unequal", "eval", "r101")})
    logs = [open(f"{out}/cli.json.{r}.log").read() for r in range(WORLD)]
    return dict(res=res, out=out, cfg=vgg, jax=jax_res, cli_logs=logs, cli_out=cli_out)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _check_steps(ranks, alone, exact_boxes=False):
    """World 2 (``ranks``' steps) against world 1 (``alone``'s)."""
    for i, want in enumerate(alone):
        steps = [r[i] for r in ranks]
        assert steps[0]["digest"] == steps[1]["digest"], f"replicas differ after step {i + 1}"
        got = {k: torch.cat([s["sampled"][k] for s in steps]) for k in want["sampled"]}
        for k in ("at_labels", "pt_labels", "pt_valid"):
            assert torch.equal(got[k], want["sampled"][k]), (i, k)
        err = float((got["pt_rois"] - want["sampled"]["pt_rois"]).abs().max())
        assert err <= (0.0 if exact_boxes else ROI_ATOL), (i, err)
        for k, v in want["metrics"].items():
            assert steps[0]["metrics"][k] == steps[1]["metrics"][k], (i, k)
            assert _rel(steps[0]["metrics"][k], v) <= RTOL, (i, k, steps[0]["metrics"][k], v)


@pytest.mark.parametrize("backbone", ["vgg16", "resnet101"])
def test_world_two_step_equals_world_one(dp, backbone):
    """Two steps on two ranks (one image each) against one process on the
    same global batches of two: the replicas bit-identical after each
    step, the sampled sets equal (the tiny VGG-16 draws dropout masks too:
    each rank keeps its rows of the global batch's), losses and grad_norm
    within 1e-5; VGG-16's parameters after the two steps within 1e-5 of
    each tensor's largest magnitude.  ResNet-101's FrozenBN leaves'
    gradients enter grad_norm on both sides."""
    name = "vgg" if backbone == "vgg16" else "r101"
    ranks = [r["steps"] for r in dp["res"][name]]
    alone = dp["res"][f"{name}_alone"]["steps"]
    assert len(alone) == 2
    _check_steps(ranks, alone)
    if backbone == "vgg16":
        got, want = dp["res"]["vgg"][0]["params"], dp["res"]["vgg_alone"]["params"]
        for k, v in want.items():
            assert float((got[k] - v).abs().max()) <= RTOL * float(v.abs().max()), k
        assert alone[0]["metrics"]["num_fg_rois"] > 0


def test_unequal_valid_counts_use_the_global_denominator(dp):
    """Rank 1's image has no candidate, so all of its slots are invalid:
    16 valid slots on rank 0, none on rank 1.  ``cls_loss`` divides by the
    group's count, so world 2 equals world 1; the mean of the ranks' own
    masked means would be half of it (rank 1's is 0)."""
    ranks = [r["steps"] for r in dp["res"]["unequal"]]
    alone = dp["res"]["unequal_alone"]["steps"]
    counts = [int(r[0]["sampled"]["pt_valid"].sum()) for r in ranks]
    assert counts == [16, 0]
    _check_steps(ranks, alone, exact_boxes=True)
    cls = ranks[0][0]["metrics"]["cls_loss"]
    assert cls > 0 and _rel(cls, alone[0]["metrics"]["cls_loss"]) <= RTOL
    assert _rel(cls, 0.5 * cls) > 0.5


def test_world_two_step_matches_jax_mesh_step(dp):
    """The port's step on two ranks against JAX's ``make_train_step`` on a
    two-device mesh, with JAX's draws handed in: the losses, counts and
    grad_norm, and the updated parameters (see the module docstring)."""
    ranks = dp["res"]["xtrain"]
    (got,) = ranks[0]["steps"]
    assert got["digest"] == ranks[1]["steps"][0]["digest"]
    want = dp["jax"]["metrics"]
    for k in ("num_fg_anchors", "num_fg_rois"):
        assert got["metrics"][k] == want[k], k
    for k in LOSSES:
        assert _rel(got["metrics"][k], want[k]) <= 1e-4, (k, got["metrics"][k], want[k])
    assert _rel(got["metrics"]["grad_norm"], want["grad_norm"]) <= 1e-3
    params = ranks[0]["params"]
    for k, w in dp["jax"]["params"].items():
        assert float((params[k] - torch.from_numpy(w)).abs().max()) <= 1e-5 * np.abs(w).max(), k


def test_checkpoint_written_at_world_two_resumes_at_world_one(dp, tmp_path):
    """The two-rank trainer: only rank 0 wrote ckpt_1 and ckpt_2 (the other
    waited at the barrier), and the replicas are bit-identical after each
    step.  A Trainer at world size 1 on ckpt_1 alone restores that state
    exactly and continues from it: its step 2 is ckpt_2 within the
    tolerance of the two worlds."""
    from chip_smoke import digest

    ranks = dp["res"]["trainer"]
    assert ranks[0]["digests"] == ranks[1]["digests"] and ranks[0]["step"] == 2
    names = sorted(os.listdir(f"{dp['out']}/ckpt"))
    assert names == ["ckpt_00000001.pt", "ckpt_00000002.pt"], names
    cfg = dp["cfg"]
    batches = torch.load(f"{dp['out']}/vgg_batches.pt")

    def trainer(d):
        model = make_model(cfg, device="cpu")
        return Trainer(model, cfg, TrainConfig(total_iters=2, checkpoint_every=0,
                                               checkpoint_dir=str(d)), device="cpu")
    shutil.copy(f"{dp['out']}/ckpt/ckpt_00000001.pt", tmp_path)
    t = trainer(tmp_path)
    assert t.state.step == 1 and t.group is None
    assert digest(t.state.model, t.state.optimizer.momentum) == ranks[0]["digests"][0]
    t.fit(batches[1:])
    assert t.state.step == 2
    want = torch.load(f"{dp['out']}/ckpt/ckpt_00000002.pt")
    for k, v in t.state.model.state_dict().items():
        assert float((want["model"][k] - v).abs().max()) <= RTOL * float(v.abs().max()), k


def test_evaluator_on_two_ranks_equals_one(dp):
    """The evaluator sharded over two ranks (global batch 4, 2 a rank) on 7
    synthetic images of both canvas buckets, against one process at batch
    2: every image once, its detections equal, the same metrics on both
    ranks and in the one process; ``eval_images`` the whole set,
    ``last_local_images`` each rank's share (4 each: the partial global
    bucket repeats images into both shards)."""
    ranks, alone = dp["res"]["eval"], dp["res"]["eval_alone"]
    ids = [d["id"] for d in ranks[0]["detections"]]
    assert ids == [d["id"] for d in ranks[1]["detections"]]
    assert sorted(ids) == sorted(d["id"] for d in alone["detections"]) and len(set(ids)) == 7
    want = {d["id"]: d for d in alone["detections"]}
    n = 0
    for d in ranks[0]["detections"]:
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(d[k], want[d["id"]][k])
        n += len(d["scores"])
    assert n > 7
    for k, v in alone["metrics"].items():
        if k != "eval_seconds":
            assert ranks[0]["metrics"][k] == ranks[1]["metrics"][k] == pytest.approx(v), k
    assert ranks[0]["metrics"]["eval_images"] == 7
    assert sum(r["local_images"] for r in ranks) >= 7
    assert len(set().union(*(r["batches"] for r in ranks))) == 2


def test_train_cli_with_explicit_process_flags(dp):
    """The train CLI as two processes (--coordinator file://...,
    --num_processes 2, --process_id): one step at a global batch of 2 and
    the evaluator hook over the same group; process 0 alone logs the step
    (imgs_per_sec over the global batch), the evaluation and the end, and
    writes the checkpoint."""
    first, second = dp["cli_logs"]
    lines = [json.loads(x) for x in first.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == [1, 1]
    assert "imgs_per_sec" in lines[0] and np.isfinite(lines[0]["loss"])
    assert "eval_mAP" in lines[1]
    assert "2 process(es)" in first and "training done" in first
    assert not any(x.startswith("{") or "training done" in x for x in second.splitlines())
    assert os.listdir(dp["cli_out"]) == ["ckpt_00000001.pt"]


def test_train_cli_distributed_from_the_environment(tmp_path, monkeypatch):
    """--distributed reads the group from the environment, as torchrun
    sets it (here world size 1 on a free port, gloo for --device cpu):
    the trainer runs on the group, and a second ``initialize`` joins
    nothing new."""
    from chip_smoke import free_port
    from trcnn_torch.cli import train

    cfg = _port_cfg(_tiny_cfg())
    monkeypatch.setattr(train, "make_config", lambda backbone, preset="voc": cfg)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(free_port()), "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        trainer = train.run(["--dataset", "synthetic", "--iters", "1", "--batch_size", "1",
                             "--out", str(tmp_path), "--no_writer", "--device", "cpu",
                             "--distributed"])
        assert torch.distributed.get_backend() == "gloo" and trainer.group is not None
        assert trainer.state.step == 1 and trainer.state.group is trainer.group
        assert parallel.initialize() == torch.device("cpu") and parallel.world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
    assert os.listdir(tmp_path) == ["ckpt_00000001.pt"]


def test_initialize_from_arguments_is_idempotent(tmp_path):
    """Without a group: world size 1, rank 0, the main process; NCCL asked
    for where there is no CUDA device raises before any group exists (no
    fallback).  With the JAX arguments (a file:// coordinator, the world
    size, the rank): gloo on the CPU, and a second call joins nothing
    new."""
    assert (parallel.world_size(), parallel.rank(), parallel.is_main_process()) == (1, 0, True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            parallel.initialize(f"file://{tmp_path}/nccl", 1, 0, backend="nccl")
        assert not torch.distributed.is_initialized()
    try:
        dev = parallel.initialize(f"file://{tmp_path}/store", 1, 0)
        assert dev == torch.device("cpu") and torch.distributed.get_backend() == "gloo"
        group = torch.distributed.group.WORLD
        assert parallel.initialize(f"file://{tmp_path}/other", 1, 0) == dev
        assert torch.distributed.group.WORLD is group
        assert (parallel.world_size(), parallel.rank(), parallel.is_main_process()) == (1, 0, True)
        assert parallel.host_gather({"a": 1}, group) == [{"a": 1}]
        t = [torch.ones(3), torch.arange(4.0)]
        parallel.all_reduce_sum_(t, group)
        assert torch.equal(t[1], torch.arange(4.0))
    finally:
        torch.distributed.destroy_process_group()
    assert parallel.world_size() == 1


def test_draws_are_rows_of_the_global_batch():
    """Rank i of n draws the global batch's uniforms and dropout masks and
    keeps its rows: the n ranks' rows, stacked, are one process's draws."""
    cfg = _port_cfg(_tiny_cfg())
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    whole = model.draw_uniforms(4, (4, 6), 3, torch.Generator().manual_seed(1))
    parts = [model.draw_uniforms(2, (4, 6), 3, torch.Generator().manual_seed(1), (i, 2))
             for i in range(2)]
    for k in UNIFORM_KEYS:
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    pooled = torch.randn(8, 7, 7, 512)
    with torch.no_grad():
        want = model.head(pooled, torch.Generator().manual_seed(2))
        got = [model.head(pooled[4 * i:4 * (i + 1)], torch.Generator().manual_seed(2), (i, 2))
               for i in range(2)]
    for j in range(2):
        assert torch.equal(torch.cat([g[j] for g in got]), want[j])
