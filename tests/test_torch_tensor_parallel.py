"""The port's fc6/fc7 tensor parallelism on the CPU: ``make_mesh``'s
(data, model) grid, the sharded head and step, the trainer's checkpoints
across grids, the evaluator on a grid and ``dryrun_multichip``, over gloo.

Four ranks on a 2 x 2 grid run as processes (``tests/torch_dp_worker.py``,
launched once for the module as ``tests/test_torch_parallel.py`` launches
its ranks; its launcher, inputs and tolerances are reused), beside one
process at world size 1 on the whole global batch, and a second 2 x 2 grid
takes JAX's inputs once this process has made them; JAX's 2 x 2
``make_mesh`` step compiles here meanwhile.

Tolerances, the grid against world 1 on the same global batches, float32:
sampled sets and fg counts equal (the sampled RoI boxes within 1e-2 pixel,
as between data-parallel world sizes); losses and grad_norm within 1e-5 relative
(fc7's partial products are summed in another order than one product
sums them); the parameters after two steps within 1e-5 of each tensor's
largest magnitude, each rank's fc6/fc7 block against the same block of
world 1's; every replicated parameter bit-identical on the four ranks.
Against JAX's step on a 2 x 2 mesh: tests/test_torch_parallel.py's (losses
1e-4 relative, counts equal, grad_norm 1e-3, parameters 1e-5 of each
tensor's largest magnitude).
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from tests.test_torch_parallel import (EVAL_SET, JOIN_S, LOSSES, ROI_ATOL, RTOL, _batches,
                                       _join, _launch, _load, _port_cfg, _r101_model, _rel,
                                       _xtrain)
from tests.test_torch_resnet_train import _cfg as _r101_cfg
from tests.test_torch_train import _jax_state
from trcnn.config import ProposalTargetConfig
from trcnn.train.optim import make_optimizer
from trcnn.train.step import make_mesh as jax_make_mesh
from trcnn.train.step import make_train_step, param_shardings as jax_param_shardings
from trcnn_torch import parallel
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.entry import dryrun_multichip, tiny_config
from trcnn_torch.models import make_model
from trcnn_torch.parallel import tensor
from trcnn_torch.train.step import train_step
from trcnn_torch.train.trainer import TrainConfig, Trainer
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

WORLD, N_MODEL = 4, 2
SHARDED = {"head.fc6.weight": 0, "head.fc7.weight": 1}   # torch's split dim


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Every multi-process job of this file: four ranks on a 2 x 2 grid and
    one process at world size 1, then a 2 x 2 grid on JAX's inputs, and
    JAX's 2 x 2 mesh step meanwhile.  Yields the results and removes the
    files after the module's tests."""
    out = str(tmp_path_factory.mktemp("grid"))
    vgg = _port_cfg(_tiny_cfg())
    r101 = _port_cfg(_r101_cfg().replace(proposal_targets=ProposalTargetConfig(rois_per_image=8)))
    torch.save(make_model(vgg, device="cpu").init(torch.Generator().manual_seed(3)).state_dict(),
               f"{out}/vgg_state.pt")
    torch.save(_r101_model(r101).state_dict(), f"{out}/r101_state.pt")
    torch.save(_batches(vgg, 2), f"{out}/vgg_batches.pt")
    torch.save(_batches(r101, 1, seed=6), f"{out}/r101_batches.pt")
    eval_set = dict(EVAL_SET, n=3)

    def job(name, kind, cfg, state, **kw):
        return {"name": name, "kind": kind, "cfg": dataclasses.asdict(cfg),
                "state": f"{out}/{state}_state.pt", **kw}

    common = [job("vgg", "step", vgg, "vgg", batches=f"{out}/vgg_batches.pt", keep_params=True),
              job("r101", "step", r101, "r101", batches=f"{out}/r101_batches.pt"),
              job("eval", "eval", vgg, "vgg", dataset=eval_set, score_thresh=0.0, batch_size=1)]
    ranked = [dict(j) for j in common] + [
        job("head", "head", vgg, "vgg"),
        job("trainer", "trainer", vgg, "vgg", batches=f"{out}/vgg_batches.pt",
            ckpt_dir=f"{out}/ckpt", resume=[1, WORLD])]
    ranked[2]["batch_size"] = 2
    launches = [
        _launch(f"{out}/alone.json", {"store": None, "world": 1, "out": out, "jobs": common}, [0]),
        _launch(f"{out}/ranks.json", {"store": f"file://{out}/store", "world": WORLD,
                                      "n_model": N_MODEL, "out": out, "jobs": ranked},
                range(WORLD))]
    try:
        xjcfg, jmodel, params, trace, xbatch, key = _xtrain(out, tmp_path_factory)
        xjob = job("xtrain", "step", _port_cfg(xjcfg), "xtrain",
                   batches=f"{out}/xtrain_batches.pt", uniforms=f"{out}/xtrain_uniforms.pt",
                   momentum=f"{out}/xtrain_momentum.pt", keep_params=True)
        launches.append(_launch(f"{out}/xranks.json", {
            "store": f"file://{out}/xstore", "world": WORLD, "n_model": N_MODEL, "out": out,
            "jobs": [xjob]}, range(WORLD)))
        # JAX's step on a (data=2, model=2) mesh: fc6/fc7 sharded over model
        # (create_sharded's placement), the batch's rows over data
        tx = make_optimizer(params, xjcfg.optim)
        mesh = jax_make_mesh(n_data=2, n_model=N_MODEL, devices=jax.devices()[:WORLD])
        sharding = jax.sharding.NamedSharding
        jstate = jax.device_put(_jax_state(params, tx, trace, 0),
                                sharding(mesh, jax.sharding.PartitionSpec()))
        jstate = jstate.replace(params=jax.device_put(jstate.params,
                                                      jax_param_shardings(jstate.params, mesh)))
        assert "model" in str(jstate.params["params"]["head"]["fc6"]["kernel"].sharding.spec)
        jbatch = {k: jax.device_put(v.numpy(), sharding(mesh, jax.sharding.PartitionSpec("data")))
                  for k, v in xbatch.items()}
        jnew, jmetrics = make_train_step(jmodel, tx, mesh, donate=False)(jstate, jbatch, key)
        jax_res = {"metrics": {k: float(v) for k, v in jmetrics.items()},
                   "params": {k: v.numpy() for k, v in
                              flax_to_state_dict(jax.tree.map(np.asarray, jnew.params)).items()}}
    finally:
        _join(launches, JOIN_S)
    res = {name: [_load(out, name, r) for r in range(WORLD)]
           for name in ("vgg", "r101", "eval", "head", "trainer", "xtrain")}
    res.update({f"{name}_alone": _load(out, name, "alone") for name in ("vgg", "r101", "eval")})
    yield dict(res=res, out=out, cfg=vgg, jax=jax_res)
    shutil.rmtree(out, ignore_errors=True)      # about 1 GB of states and checkpoints


def _check_grid_steps(ranks, alone):
    """The 2 x 2 grid's steps (``ranks``, rank r at (r // 2, r % 2))
    against world 1's (``alone``)."""
    for i, want in enumerate(alone):
        steps = [r[i] for r in ranks]
        # replicas of one model index (data indices 0 and 1) hold the same bits
        assert steps[0]["digest"] == steps[2]["digest"] and steps[1]["digest"] == steps[3]["digest"]
        for a, b in ((0, 1), (2, 3)):       # the model ranks of one data index sample alike
            for k, v in steps[a]["sampled"].items():
                assert torch.equal(v, steps[b]["sampled"][k]), (i, k)
        got = {k: torch.cat([steps[0]["sampled"][k], steps[2]["sampled"][k]])
               for k in want["sampled"]}
        for k in ("at_labels", "pt_labels", "pt_valid"):
            assert torch.equal(got[k], want["sampled"][k]), (i, k)
        assert float((got["pt_rois"] - want["sampled"]["pt_rois"]).abs().max()) <= ROI_ATOL
        for k, v in want["metrics"].items():
            assert len({s["metrics"][k] for s in steps}) == 1, (i, k)
            if k.startswith("num_fg"):
                assert steps[0]["metrics"][k] == v, (i, k)
            assert _rel(steps[0]["metrics"][k], v) <= RTOL, (i, k, steps[0]["metrics"][k], v)


def test_grid_two_steps_equal_world_one(grid):
    """Two steps of the small VGG-16 config (dropout on) on a 2 x 2 grid,
    one image per data index, against one process on the same global
    batches of two: sampled sets and fg counts equal, losses and grad_norm
    within 1e-5; fc6 and fc7 halved (rows of fc6, columns of fc7), each
    rank's blocks within 1e-5 of world 1's same blocks after the two steps,
    and every other parameter bit-identical on all four ranks."""
    ranks = grid["res"]["vgg"]
    alone = grid["res"]["vgg_alone"]
    assert [r["mesh"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check_grid_steps([r["steps"] for r in ranks], alone["steps"])
    assert alone["steps"][0]["metrics"]["num_fg_rois"] > 0
    want = alone["params"]
    assert len({r["replicated"] for r in ranks}) == 1
    assert sorted(ranks[0]["blocks"]) == sorted(SHARDED)
    for k, v in want.items():
        if k in SHARDED:
            dim = SHARDED[k]
            w = v.shape[dim] // N_MODEL
            for r in ranks:
                block = r["blocks"][k]
                assert block.shape[dim] == w and block.shape[1 - dim] == v.shape[1 - dim], k
                ref = v.narrow(dim, r["mesh"][1] * w, w)
                assert float((block - ref).abs().max()) <= RTOL * float(v.abs().max()), k
                assert torch.equal(block, ranks[0]["params"][k].narrow(dim, r["mesh"][1] * w, w))
        assert float((ranks[0]["params"][k] - v).abs().max()) <= RTOL * float(v.abs().max()), k


def test_grid_step_matches_jax_mesh_step(grid):
    """The port's step on a 2 x 2 grid against JAX's ``make_train_step`` on
    a 2 x 2 ``make_mesh`` (fc6/fc7 sharded over ``model``), with JAX's
    draws handed in: losses, counts, grad_norm and the updated parameters,
    fc6/fc7 put whole from the model ranks' blocks."""
    ranks = grid["res"]["xtrain"]
    got = ranks[0]["steps"][0]
    assert got["digest"] == ranks[2]["steps"][0]["digest"]
    want = grid["jax"]["metrics"]
    for k in ("num_fg_anchors", "num_fg_rois"):
        assert got["metrics"][k] == want[k], k
    for k in LOSSES:
        assert _rel(got["metrics"][k], want[k]) <= 1e-4, (k, got["metrics"][k], want[k])
    assert _rel(got["metrics"]["grad_norm"], want["grad_norm"]) <= 1e-3
    assert len({r["replicated"] for r in ranks}) == 1
    params = ranks[0]["params"]
    for k, w in grid["jax"]["params"].items():
        assert float((params[k] - torch.from_numpy(w)).abs().max()) <= 1e-5 * np.abs(w).max(), k


def test_checkpoint_from_a_grid_resumes_on_another_grid_and_alone(grid):
    """The 2 x 2 trainer wrote ckpt_1 and ckpt_2 in the one-process format
    (whole fc6/fc7 and traces: rank 0 gathered and wrote); a Trainer
    on a 1 x 4 grid over the same directory restores ckpt_2 bit-equal
    (parameters and momentum gathered back whole on every rank), its fc6
    cut in four, and one more step moves fc6.  A Trainer at world size 1
    on the directory restores ckpt_2 bit-equal too and one more step moves
    it (both steps through ``train_step``: no checkpoint is written)."""
    from chip_smoke import digest

    ranks = grid["res"]["trainer"]
    assert [r["step"] for r in ranks] == [2] * WORLD
    assert ranks[0]["digests"] == ranks[2]["digests"] and ranks[1]["digests"] == ranks[3]["digests"]
    cfg = grid["cfg"]
    for r in ranks:
        res = r["resumed"]
        assert res["step"] == 2 and res["mesh"] == {"data": 1, "model": WORLD}
        assert res["equal"] and res["fc6"] == (cfg.head_hidden // WORLD, 7 * 7 * 512)
        assert res["moved"] > 0 and res["step_after"] == 3
    names = sorted(os.listdir(f"{grid['out']}/ckpt"))
    assert names == ["ckpt_00000001.pt", "ckpt_00000002.pt"], names
    ck = torch.load(f"{grid['out']}/ckpt/ckpt_00000002.pt")
    assert set(ck) == {"model", "optimizer", "step"} and set(ck["optimizer"]) == {"momentum"}
    assert ck["model"]["head.fc6.weight"].shape == (cfg.head_hidden, 7 * 7 * 512)
    t = Trainer(make_model(cfg, device="cpu"), cfg, TrainConfig(
        total_iters=3, checkpoint_every=0, checkpoint_dir=f"{grid['out']}/ckpt"), device="cpu")
    assert t.state.step == 2 and t.mesh.shape == {"data": 1, "model": 1}
    for k, v in t.state.model.state_dict().items():
        assert torch.equal(v, ck["model"][k]), k
    for k, v in t.state.optimizer.momentum.items():
        assert torch.equal(v, ck["optimizer"]["momentum"][k]), k
    before = digest(t.state.model)
    train_step(t.state, torch.load(f"{grid['out']}/vgg_batches.pt")[0])
    assert t.state.step == 3 and digest(t.state.model) != before
    assert not torch.equal(t.state.model.head.fc6.weight, ck["model"]["head.fc6.weight"])


def test_checkpoint_is_gathered_on_the_writing_rank_only(grid, tmp_path):
    """In each of the 2 x 2 trainer's saves, only the writing rank (rank 0)
    made a tensor of the whole fc6 or fc7 weight's shape (every operation
    watched, collectives and host copies included); the other three held
    their blocks only.  The checkpoint is, byte for byte, the one a
    Trainer at world size 1 writes for the same state."""
    ranks = grid["res"]["trainer"]
    saves = [r["whole_in_save"] for r in ranks]     # two per fit: every step's and the last
    assert saves == [[True] * 4] + [[False] * 4] * 3, saves
    cfg = grid["cfg"]
    name = "ckpt_00000002.pt"
    ck = torch.load(f"{grid['out']}/ckpt/{name}")
    t = Trainer(make_model(cfg, device="cpu"), cfg, TrainConfig(
        checkpoint_every=0, checkpoint_dir=str(tmp_path)), device="cpu")
    tensor.load_whole_(t.state.model, t.state.optimizer, ck["model"], ck["optimizer"]["momentum"])
    t.state.step = ck["step"]
    t.save()
    with open(f"{grid['out']}/ckpt/{name}", "rb") as a, open(tmp_path / name, "rb") as b:
        assert a.read() == b.read()


def test_fc6_bias_gradient_is_summed_over_the_model_group(grid):
    """The head alone on the 2 x 2 grid against the whole head in each
    process, on the same crops: outputs, the crops' gradient (the RoI
    pool's: whole before K4) and every parameter gradient (fc6's and fc7's
    as their blocks) within 1e-5.  The replicated fc6 bias takes its
    gradient summed over the model group, the same bits on both model
    ranks; without that sum each rank holds only its own columns' share
    (zero elsewhere), so one update would part the replicas."""
    ranks = grid["res"]["head"]
    for r, res in enumerate(ranks):
        whole, got = res["whole"], res["summed"]
        j = r % N_MODEL
        for a, b in zip(got["out"] + [got["dx"]], whole["out"] + [whole["dx"]]):
            assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())
        for k, g in whole["grads"].items():
            want = g
            dim = SHARDED.get(f"head.{k}")
            if dim is not None:
                w = g.shape[dim] // N_MODEL
                want = g.narrow(dim, j * w, w)
            assert float((got["grads"][k] - want).abs().max()) <= RTOL * float(g.abs().max()), k
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(ranks[a]["summed"]["grads"]["fc6.bias"],
                           ranks[b]["summed"]["grads"]["fc6.bias"])
        parted = [ranks[r]["not summed"]["grads"]["fc6.bias"] for r in (a, b)]
        assert not torch.equal(*parted)
        summed = ranks[a]["summed"]["grads"]["fc6.bias"]
        w = summed.shape[0] // N_MODEL
        assert not parted[0][w:].any() and not parted[1][:w].any()
        assert torch.equal(parted[0][:w], summed[:w]) and torch.equal(parted[1][w:], summed[w:])


def test_resnet101_on_a_model_axis_is_replicated_and_equals_world_one(grid):
    """ResNet-101-C4 has no fc6/fc7: on the 2 x 2 grid every parameter is
    replicated (all four ranks bit-identical after the step), the model
    ranks repeat the data index's work, and the step equals world 1's."""
    ranks = [r["steps"] for r in grid["res"]["r101"]]
    assert len({r[0]["digest"] for r in ranks}) == 1
    _check_grid_steps(ranks, grid["res"]["r101_alone"]["steps"])


def test_evaluator_on_a_grid_equals_one_process(grid):
    """The evaluator on the 2 x 2 grid (global batch 2: one image per data
    index, fc6/fc7 gathered whole for the pass) against one process at
    batch 1: every image once, its detections equal, the same metrics on
    all four ranks; the two model ranks of a data index detect the same
    images."""
    ranks, alone = grid["res"]["eval"], grid["res"]["eval_alone"]
    want = {d["id"]: d for d in alone["detections"]}
    for r in ranks:
        assert sorted(d["id"] for d in r["detections"]) == sorted(want)
        for d in r["detections"]:
            for k in ("boxes", "scores", "classes"):
                np.testing.assert_array_equal(d[k], want[d["id"]][k])
        for k, v in alone["metrics"].items():
            if k != "eval_seconds":
                assert r["metrics"][k] == pytest.approx(v), k
    assert ranks[0]["local_images"] == ranks[1]["local_images"]
    assert ranks[2]["local_images"] == ranks[3]["local_images"]
    assert sum(d["scores"].size for d in alone["detections"]) > 3


def test_dryrun_multichip_on_four_cpu_processes(capsys):
    """``dryrun_multichip(4, device="cpu")``: a 2 x 2 grid of gloo
    processes takes one step of the tiny config with JAX's assertions (fg
    anchors and RoIs, all four losses and grad_norm positive)."""
    m = dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "grid: data 2 x model 2" in out and "dryrun_multichip ok:" in out
    assert all(np.isfinite(v) for v in m.values())


def test_mesh_and_shardings_without_a_group():
    """Without a process group only the 1 x 1 grid exists (no group, the
    step unchanged); a larger one raises.  ``param_shardings`` names fc6's
    weight column-parallel and fc7's row-parallel on VGG-16 and nothing on
    ResNet-101-C4; a width the model axis does not divide raises; the tiny
    config is ``__graft_entry__._tiny_cfg``'s."""
    assert parallel.make_mesh() == parallel.Mesh()
    assert parallel.Mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="grid"):
        parallel.make_mesh(2, 2)
    assert dataclasses.asdict(tiny_config()) == dataclasses.asdict(_tiny_cfg())
    vgg = make_model(tiny_config(), device="cpu")
    kinds = {k: v for k, v in tensor.param_shardings(vgg).items() if v}
    assert kinds == {"head.fc6.weight": "column", "head.fc7.weight": "row"}
    r101 = make_model(_port_cfg(_r101_cfg()), device="cpu")
    assert not any(tensor.param_shardings(r101).values())
    mesh = parallel.Mesh(n_data=1, n_model=3, model_index=2)
    w = vgg.head.fc6.weight
    with pytest.raises(ValueError, match="does not split"):
        tensor.local_slice(w, "column", mesh)
    half = tensor.local_slice(w.detach(), "row",
                              dataclasses.replace(mesh, n_model=2, model_index=1))
    assert torch.equal(half, w.detach()[:, w.shape[1] // 2:])
