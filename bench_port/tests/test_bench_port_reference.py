"""The benchmark's float32 reference against the port's float32 path on
the CPU at tiny configurations: the same weights and inputs give the same
stages, the discrete ones exactly.  This test imports both; the reference
imports neither the port nor the JAX package."""

import numpy as np
import pytest
import torch

from bench_port import check, harness, traffic
from bench_port.reference import boxes as rb
from bench_port.reference import nets
from bench_port.reference import train as rt
from bench_port.tests import bench_port_tiny as tiny
from trcnn_torch.train import step as step_mod


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def setup(config, kind, seed=2 ** 31 + 3):
    conf = dict(config, dtype="float32")
    cfg = harness.model_config(conf)
    t = tiny.traffic("tiny_vgg" if config is tiny.TINY_VGG else "tiny_r101", kind)
    pool = traffic.make_pool(t, cfg, conf["batch_size"], conf["gt_capacity"], seed, "cpu")
    w = harness.make_weights(cfg, seed, pool, "cpu")
    model = harness.build_model(cfg, conf, w, kind, "cpu")
    return cfg, pool, w, model


@pytest.mark.parametrize("config", [tiny.TINY_VGG, tiny.TINY_R101], ids=["vgg16", "r101"])
def test_detect_stages_match_the_port(config):
    cfg, pool, w, model = setup(config, "detect")
    batch = pool[0]
    cap = check.DetectCapture()
    handles = cap.hooks(model)
    cap.raw, cap.dets = harness.detect_call(model, batch, cfg)
    for h in handles:
        h.remove()
    numbers = check.detect_numbers(cap, batch["images"], batch["im_info"], w, cfg)
    assert numbers["proposals"] == 0 and numbers["detections"] == 0
    # a max pool rounds nothing; RoIAlign in float32 sums in another order
    assert numbers["crops"] == 0 if cfg.roi.mode == "max" else numbers["crops"] < 1e-5
    assert cap.crops.shape[0] == min(cfg.proposals.post_nms_topk_test, check.CROP_ROWS)
    for k in ("feat", "rpn", "head", "chain"):
        assert numbers[k] < 1e-4, (k, numbers)
    assert cap.dets[3].any(), "the epilogue kept no detection"


@pytest.mark.parametrize("config", [tiny.TINY_VGG, tiny.TINY_R101], ids=["vgg16", "r101"])
def test_training_steps_match_the_port(config):
    cfg, pool, w, model = setup(config, "train")
    state = step_mod.TrainState.create(model)
    rpn = []
    h = model.rpn.register_forward_hook(
        lambda _m, _a, out: rpn.append((out.fg_probs.detach().clone(),
                                        out.deltas.detach().clone())))
    p0 = {k: v.clone() for k, v in w.items()}
    losses, momentum = [], None
    for s in range(3):
        m = step_mod.train_step(state, pool[s], seed=7)
        losses.append({k: float(v) for k, v in m.items()})
        if s == 0:
            momentum = {k: v.clone() for k, v in state.optimizer.momentum.items()}
    h.remove()
    props = [rb.proposals(f, d, b["im_info"], cfg, train=True) for (f, d), b in zip(rpn, pool)]
    w_ref = {k: v.clone() for k, v in p0.items()}
    ref_losses, ref_grad = rt.run_steps(w_ref, cfg, pool[:3], props, 7, torch.float32)
    # the first step from the same weights agrees to float32 rounding; the
    # later ones from weights a step's rounding apart, amplified by the
    # update, to 1e-3
    for step, (p, r) in enumerate(zip(losses, ref_losses)):
        for k in rt.LOSSES + ("loss",):
            assert p[k] == pytest.approx(r[k], rel=1e-5 if step == 0 else 1e-3, abs=1e-6), k
    numbers, _ = check.train_numbers(
        losses, check.port_first_gradient(momentum, p0, cfg.optim),
        {k: p.detach() - p0[k] for k, p in model.named_parameters()}, ref_losses, ref_grad,
        {k: w_ref[k] - p0[k] for k in p0}, cfg.backbone)
    assert numbers["loss"] < 1e-4 and numbers["grad"] < 1e-3 and numbers["change"] < 1e-3, numbers


def test_proposal_and_epilogue_oracles_on_ties():
    boxes = np.array([[0, 0, 9, 9], [0, 0, 9, 9], [20, 20, 29, 29], [1, 1, 10, 10]], np.float32)
    # box 3 overlaps box 0 by 81 / 119 = 0.68: kept at 0.7, suppressed at 0.6
    assert rb.greedy_nms(boxes, 0.7, 10) == [0, 2, 3]
    assert rb.greedy_nms(boxes, 0.6, 10) == [0, 2]
    assert rb.greedy_nms(boxes, 0.7, 1) == [0]
    assert list(rb.stable_desc(np.array([0.5, 0.9, 0.5], np.float32))) == [1, 0, 2]
    a = rb.base_anchors()
    assert a.shape == (9, 4) and a[0].tolist() == [-84.0, -40.0, 99.0, 55.0]


def test_fp8_control_rounds_every_product():
    w = {"x.weight": torch.randn(8, 4) * 0.3, "x.bias": torch.zeros(8)}
    x = torch.randn(5, 4)
    plain = nets.Net(w, "vgg16", 2, 7).dense(x, "x")
    q = nets.Net(w, "vgg16", 2, 7, quant="fp8").dense(x, "x")
    assert not torch.equal(plain, q)
    assert (plain - q).abs().max() < 0.2 * plain.abs().max()
