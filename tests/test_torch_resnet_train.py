"""The port's ResNet-101-C4 training step against the JAX package, on the CPU.

Weights and the first image are tests/test_cross_impl_resnet.py's
``_fixture`` (live conv3 kernels and random FrozenBN leaves; built once
per run with tests/test_torch_resnet.py, ``shared_fixture``); the second
image is the first mirrored, and the gt boxes, im_info rows and sampling
capacities are those of tests/test_cross_impl_train.py.  JAX's sampling
draws are replayed outside its graph and handed to the port, so every
sampling decision is comparable.  float32.  The JAX side compiles one
``jax.value_and_grad`` of ``losses`` and applies the optax chain of
``make_optimizer(params, cfg.optim, "resnet101")`` to those gradients; no
JAX train step is compiled.

Tolerances: losses within 1e-4 relative, counts equal; gradients within
1e-2 of each trained tensor's largest JAX gradient, and their median
ratio within 1e-3; one update's parameters and momentum trace within 1e-5
of each tensor's largest magnitude plus what the gradient tolerance
allows (lr x 1e-2 x the largest gradient); frozen parameters (conv1, bn1,
res2, every FrozenBN leaf) bit-unchanged on both sides.  Measured: the
worst gradient ratio 1.7e-3 (res4.block17.conv2), the median 8e-5 over
the 103 trained tensors.  The gradients' float32 noise is of that size by
itself here: the port's own gradients at 8 and at 1 torch threads differ
by up to 3.8e-3 in the same tensor (median 1.2e-4), as float32 differs
from float64, since last-bit differences through 101 layers with random
FrozenBN scales move a few ReLU and pooling decisions.

The FrozenBN leaves of res3-res5 take gradients on both sides: JAX
differentiates them and masks their update after the momentum trace; the
port does the same, so their gradients count in the global norm
(``grad_norm``) and in the clip, and their trace matches JAX's.  Measured:
the port's ``grad_norm`` within 8.6e-8 of JAX's (relative); the 372
FrozenBN leaves' gradients within 2.4e-3 of each leaf's largest JAX
gradient (res4.block17.bn2.bias), median 7.7e-5, held to the trained
tensors' tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_cross_impl_resnet import _cfg as _fixture_cfg
from tests.test_cross_impl_train import _derive_uniforms, _sampling_rng
from trcnn.config import ProposalConfig, ProposalTargetConfig
from trcnn.models import make_model as jax_make_model
from trcnn.train.optim import frozen_mask, make_optimizer
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.entry import train_entry
from trcnn_torch.models import make_model
from trcnn_torch.models.faster_rcnn import UNIFORM_KEYS
from trcnn_torch.train import CaffeSGD, TrainState, learning_rate, train_step
from trcnn_torch.train.optim import is_frozen
from trcnn_torch.train.step import BATCH_KEYS
from tests.test_torch_resnet import shared_fixture  # noqa: E402
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy
B = 2
TRACE = 4          # index of optax.trace in make_optimizer's chain
GRAD_RTOL = 1e-2
# grad_norm, relative to JAX's global norm: measured 8.6e-8; leaving out the
# FrozenBN leaves' gradients, as the port did before, gives 2.0e-6
NORM_RTOL = 1e-6


def _cfg():
    return _fixture_cfg().replace(
        proposals=ProposalConfig(pre_nms_topk_train=512, post_nms_topk_train=64,
                                 pre_nms_topk_test=512, post_nms_topk_test=48),
        proposal_targets=ProposalTargetConfig(rois_per_image=16))


def _batch(images):
    gtb = np.zeros((B, 4, 4), np.float32)
    gtl = np.zeros((B, 4), np.int32)
    gtv = np.zeros((B, 4), bool)
    gtb[0, :3] = [[10, 12, 70, 60], [90, 30, 170, 100], [40, 70, 110, 115]]
    gtl[0, :3] = [3, 7, 12]
    gtb[1, :2] = [[20, 15, 95, 80], [100, 40, 150, 95]]
    gtl[1, :2] = [5, 18]
    gtv[0, :3] = gtv[1, :2] = True
    return {"images": np.concatenate([images, images[:, :, ::-1]]),
            "im_info": np.asarray([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]], np.float32),
            "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gtv}


def _flat(tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX: losses and gradients from one value_and_grad, their global
    norm, then the optax update from a random momentum trace.  The port:
    one train_step from the same parameters, trace and sampling draws."""
    cfg = _cfg()
    _, _, params, images, _ = shared_fixture(tmp_path_factory)
    model = jax_make_model(cfg, dtype=jnp.float32)
    batch = _batch(images)
    jbatch = [jnp.asarray(batch[k]) for k in BATCH_KEYS]
    drop, samp = jax.random.split(jax.random.PRNGKey(11))

    def loss_fn(p):
        out = model.apply(p, *jbatch, method="losses", rngs={"dropout": drop, "sampling": samp})
        return out["loss"], out

    (_, jmetrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = jax.tree.map(np.asarray, grads)

    rng = np.random.default_rng(0)
    trace = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
                         params)
    tx = make_optimizer(params, cfg.optim, "resnet101")
    opt = list(tx.init(params))
    opt[TRACE] = opt[TRACE]._replace(trace=trace)
    upd, new_opt = tx.update(grads, tuple(opt), params)

    fh, fw = cfg.image.pad_h // 16, cfg.image.pad_w // 16
    n, n_cand = fh * fw * cfg.anchors.num_anchors, cfg.proposals.post_nms_topk_train + 4
    _, _, uni = _derive_uniforms(_sampling_rng(model, params, samp), B, n, n_cand)
    uniforms = {k: T(np.stack([u[k] for u in uni])) for k in UNIFORM_KEYS}

    pmodel = make_model(cfg, device="cpu")
    pmodel.load_state_dict(flax_to_state_dict(params))
    state = TrainState.create(pmodel)
    state.optimizer.load_state_dict({"momentum": flax_to_state_dict(trace)})
    pmetrics = train_step(state, {k: T(np.array(v)) for k, v in batch.items()},
                          uniforms=uniforms)
    return dict(
        cfg=cfg, raw_params=params, params=_flat(params), trace=_flat(trace),
        raw_trace=trace, raw_grads=grads,
        jax_metrics={k: float(v) for k, v in jmetrics.items()},
        jax_norm=float(optax.global_norm(grads)),
        jax_grads=_flat(grads),
        jax_params=_flat(jax.tree.map(np.asarray, optax.apply_updates(params, upd))),
        jax_trace=_flat(jax.tree.map(np.asarray, new_opt[TRACE].trace)),
        metrics={k: float(v) for k, v in pmetrics.items()},
        grads={k: None if p.grad is None else p.grad.numpy()
               for k, p in pmodel.named_parameters()},
        new_params={k: v.numpy() for k, v in pmodel.state_dict().items()},
        new_trace={k: v.numpy() for k, v in state.optimizer.momentum.items()})


def _stem(name):
    """A parameter of conv1, bn1 or res2, which run without autograd in the
    port: no gradient there, and a zero one in JAX (its stop_gradient)."""
    return name.startswith(("extractor.conv1", "extractor.bn1", "extractor.res2"))


def _frozen_bn(name):
    """A FrozenBN leaf of res3-res5: frozen, but differentiated on both
    sides."""
    return is_frozen(name, "resnet101") and "bn" in name and not _stem(name)


def test_is_frozen_matches_the_jax_mask(run):
    mask = jax.tree_util.tree_flatten_with_path(frozen_mask(run["raw_params"], "resnet101"))[0]
    want = {}
    for path, frozen in mask:
        names = [p.key for p in path[1:]]
        leaf = {"kernel": "weight"}.get(names[-1], names[-1])
        want[".".join(names[:-1] + [leaf])] = bool(frozen)
    model = make_model(run["cfg"], device="cpu")
    got = {k: is_frozen(k, "resnet101") for k, _ in model.named_parameters()}
    assert got == want
    assert sum(got.values()) == 4 * 104 + 1 + 3 * 3 + 1   # FrozenBNs, conv1, res2 convs
    # the VGG-16 rule is unchanged, and a VGG model trains its FrozenBN-free head
    assert is_frozen("extractor.conv2_2.weight") and not is_frozen("head.fc6.bias")


def test_losses_match_jax(run):
    j, p = run["jax_metrics"], run["metrics"]
    assert p["num_fg_anchors"] == j["num_fg_anchors"] > 0
    assert p["num_fg_rois"] == j["num_fg_rois"] > 0
    for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss"):
        assert abs(p[k] - j[k]) <= 1e-4 * abs(j[k]), (k, p[k], j[k])
    assert p["rpn_bbox_loss"] > 0 and p["bbox_loss"] > 0


def _ratios(run, names):
    """Each tensor's largest gradient difference over its largest JAX
    gradient."""
    ratios = {}
    for name in names:
        w = run["jax_grads"][name]
        scale = np.abs(w).max()
        assert scale > 0, name
        ratios[name] = float(np.abs(run["grads"][name] - w).max() / scale)
    return ratios


def _hold(ratios, what):
    worst = max(ratios, key=ratios.get)
    print(f"{what}: worst gradient ratio {ratios[worst]:.4e} in {worst}; median "
          f"{np.median(list(ratios.values())):.2e} over {len(ratios)} tensors")
    assert np.median(list(ratios.values())) <= 1e-3
    for name, r in ratios.items():
        assert r <= GRAD_RTOL, (name, r)


def test_gradients_match_jax(run):
    """Every trained tensor's gradient within GRAD_RTOL of its largest JAX
    gradient; the stem (conv1, bn1, res2) gets none (JAX's are zero)."""
    grads, want = run["grads"], run["jax_grads"]
    assert grads.keys() == want.keys()
    for name, w in want.items():
        if _stem(name):
            assert grads[name] is None and not w.any(), name
    trained = [k for k in want if not is_frozen(k, "resnet101")]
    assert len(trained) == 530 - (4 * 104 + 11)
    _hold(_ratios(run, trained), "trained tensors")


def test_frozen_bn_gradients_match_jax(run):
    """The FrozenBN leaves of res3-res5 (scale, bias, mean, var) get
    gradients, each within GRAD_RTOL of its largest JAX gradient, as the
    trained tensors do."""
    leaves = [k for k in run["jax_grads"] if _frozen_bn(k)]
    assert len(leaves) == 4 * (104 - 11)               # all but bn1 and res2's ten
    assert all(run["grads"][k] is not None for k in leaves)
    _hold(_ratios(run, leaves), "FrozenBN leaves")


def test_grad_norm_matches_jax(run):
    """The logged grad_norm is the global norm over every gradient, the
    FrozenBN leaves' included, as optax's is: within NORM_RTOL of JAX's,
    and equal to the norm of the port's own gradients."""
    got, want = run["metrics"]["grad_norm"], run["jax_norm"]
    print(f"grad_norm {got:.8g}, JAX {want:.8g}, relative {abs(got - want) / want:.2e}")
    assert abs(got - want) <= NORM_RTOL * want
    own = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                      for g in run["grads"].values() if g is not None))
    assert abs(got - own) <= NORM_RTOL * own


def test_update_matches_jax(run):
    """One Caffe-order update: the trained parameters moved and the frozen
    ones bit-unchanged on both sides; parameters and momentum trace, the
    FrozenBN leaves' trace included, within 1e-5 of each tensor's largest
    magnitude plus what the gradient tolerance allows (lr x GRAD_RTOL x
    the largest gradient, 2x the lr for a bias)."""
    cfg = run["cfg"]
    lr = learning_rate(cfg.optim, 0)
    for name, w in run["jax_params"].items():
        got, before = run["new_params"][name], run["params"][name]
        g_max = np.abs(run["jax_grads"][name]).max()
        slack = (1 + (w.ndim <= 1)) * lr * GRAD_RTOL * g_max
        if is_frozen(name, "resnet101"):
            np.testing.assert_array_equal(got, before, err_msg=name)
            np.testing.assert_array_equal(w, before, err_msg=name)
        else:
            assert not np.array_equal(got, before), name
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max() + slack, name
        tw, tp = run["jax_trace"][name], run["new_trace"][name]
        assert np.abs(tp - tw).max() <= 1e-5 * np.abs(tw).max() + slack, name


def test_clipped_update_matches_optax(run):
    """One Caffe-order update with the global-norm clip at half the norm,
    from the port's gradients and its grad_norm, against optax's chain
    (clip first) on JAX's gradients and the same trace: the clip scales
    every gradient, the FrozenBN leaves' included, by the same factor;
    parameters and trace within the tolerances of test_update_matches_jax
    (which the clip only shrinks), the frozen parameters bit-unchanged."""
    cfg = run["cfg"]
    ocfg = dataclasses.replace(cfg.optim, clip_grad_norm=0.5 * run["jax_norm"])
    params = run["raw_params"]
    tx = make_optimizer(params, ocfg, "resnet101")
    opt = list(tx.init(params))
    opt[TRACE] = opt[TRACE]._replace(trace=run["raw_trace"])
    upd, new_opt = tx.update(run["raw_grads"], tuple(opt), params)
    want = _flat(jax.tree.map(np.asarray, optax.apply_updates(params, upd)))
    want_trace = _flat(jax.tree.map(np.asarray, new_opt[TRACE].trace))

    model = make_model(cfg, device="cpu")
    model.load_state_dict({k: T(v.copy()) for k, v in run["params"].items()})
    sgd = CaffeSGD(model, ocfg, "resnet101")
    sgd.load_state_dict({"momentum": {k: T(v.copy()) for k, v in run["trace"].items()}})
    for k, p in model.named_parameters():
        g = run["grads"][k]
        p.grad = None if g is None else T(g.copy())
    sgd.step(0, torch.tensor(run["metrics"]["grad_norm"]))
    lr = learning_rate(ocfg, 0)
    for name, w in want.items():
        got, before = model.state_dict()[name].numpy(), run["params"][name]
        slack = (1 + (w.ndim <= 1)) * lr * GRAD_RTOL * np.abs(run["jax_grads"][name]).max()
        if is_frozen(name, "resnet101"):
            np.testing.assert_array_equal(got, before, err_msg=name)
            np.testing.assert_array_equal(w, before, err_msg=name)
        else:
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max() + slack, name
        tw, tp = want_trace[name], sgd.momentum[name].numpy()
        assert np.abs(tp - tw).max() <= 1e-5 * np.abs(tw).max() + slack, name
    # the clip was active: the update is not the unclipped one
    name = "head.cls_score.weight"
    assert not np.allclose(model.state_dict()[name].numpy(), run["jax_params"][name])


def test_train_entry_resnet101_on_cpu():
    """``train_entry`` at the small R101 config, float32 (as in
    test_torch_resnet.py's entry test), one step at batch 2: finite
    losses, the trained parameters moved, every frozen one (conv1, bn1,
    res2, each FrozenBN) bit-unchanged."""
    step_fn, (state, batch) = train_entry("cpu", cfg=_cfg(), dtype=torch.float32, batch_size=2,
                                          backbone="resnet101")
    model = state.model
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = step_fn(state, batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert metrics["num_fg_rois"] > 0
    for k, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        assert moved != is_frozen(k, "resnet101"), k
