"""The port's ResNet-101-C4 with RoIAlign (``RoIConfig.mode="align"``, 14 x
14 crops) against the JAX package, on the CPU: detect, and the losses and
gradients of one training step.

Weights and images are tests/test_cross_impl_resnet.py's ``_fixture``
(built once per run, ``tests/test_torch_resnet.shared_fixture``); the
training batch, capacities and sampling draws are
tests/test_torch_resnet_train.py's, the draws handed to the port.  float32.
Tolerances are the max-pool R101 tests': proposals and detections'
validity and classes equal, cls_prob and bbox_pred within 1e-4 relative;
losses within 1e-4 relative, counts equal, gradients within 1e-2 of each
trained tensor's largest JAX gradient and their median within 1e-3 (float32
noise through 101 layers with random FrozenBN scales: the port's own
gradients at 8 and 1 torch threads differ by up to 3.8e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_cross_impl_train import _derive_uniforms, _sampling_rng
from tests.test_torch_resnet import _rel_err, shared_fixture
from tests.test_torch_resnet_train import B, GRAD_RTOL, _batch
from tests.test_torch_resnet_train import _cfg as _train_cfg
from trcnn.models import make_model as jax_make_model
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.models import make_model, postprocess
from trcnn_torch.models.faster_rcnn import UNIFORM_KEYS
from trcnn_torch.train.optim import is_frozen
from trcnn_torch.train.step import BATCH_KEYS
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy


def _align(cfg):
    return cfg.replace(roi=dataclasses.replace(cfg.roi, mode="align"))


def test_resnet101_align_detections_match_jax(tmp_path_factory):
    cfg, _, params, images, im_info = shared_fixture(tmp_path_factory)
    cfg = _align(cfg)
    model = jax_make_model(cfg, dtype=jnp.float32)

    # operation by operation: a ResNet-101 graph takes minutes to compile on the CPU
    def detect(p, x, info):
        raw = model.apply(p, x, info, method="detect")
        return raw, jax.jit(jax_postprocess, static_argnums=2)(raw, info, cfg)

    jraw, jdets = jax.tree.map(np.asarray, detect(params, images, im_info))
    pmodel = make_model(cfg, device="cpu")
    pmodel.load_state_dict(flax_to_state_dict(params))
    pmodel.eval()
    assert pmodel.pool_size == 14
    with torch.no_grad():
        raw = pmodel.detect(T(np.array(images)), T(np.array(im_info)))
        dets = postprocess(raw, T(np.array(im_info)), cfg)
    np.testing.assert_array_equal(raw.roi_valid.numpy(), jraw.roi_valid)
    np.testing.assert_allclose(raw.rois.numpy(), jraw.rois, rtol=1e-6, atol=1e-4)
    assert _rel_err(raw.cls_prob.numpy(), jraw.cls_prob) < 1e-4
    assert _rel_err(raw.bbox_pred.numpy(), jraw.bbox_pred) < 1e-4
    np.testing.assert_array_equal(dets.valid.numpy(), jdets.valid)
    assert jdets.valid.sum() > 3
    np.testing.assert_array_equal(dets.classes.numpy(), jdets.classes)
    np.testing.assert_allclose(dets.scores.numpy(), jdets.scores, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dets.boxes.numpy(), jdets.boxes, rtol=1e-4, atol=1e-3)


def test_resnet101_align_training_step_matches_jax(tmp_path_factory):
    cfg = _align(_train_cfg())
    _, _, params, images, _ = shared_fixture(tmp_path_factory)
    model = jax_make_model(cfg, dtype=jnp.float32)
    batch = _batch(images)
    jbatch = [jnp.asarray(batch[k]) for k in BATCH_KEYS]
    drop, samp = jax.random.split(jax.random.PRNGKey(11))

    def loss_fn(p):
        out = model.apply(p, *jbatch, method="losses", rngs={"dropout": drop, "sampling": samp})
        return out["loss"], out

    (_, jm), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(np.asarray, grads)).items()}
    fh, fw = cfg.image.pad_h // 16, cfg.image.pad_w // 16
    n = fh * fw * cfg.anchors.num_anchors
    n_cand = cfg.proposals.post_nms_topk_train + batch["gt_boxes"].shape[1]
    _, _, uni = _derive_uniforms(_sampling_rng(model, params, samp), B, n, n_cand)
    pmodel = make_model(cfg, device="cpu")
    pmodel.load_state_dict(flax_to_state_dict(params))
    pmodel.train()
    out = pmodel.losses(*(T(np.array(batch[k])) for k in BATCH_KEYS), generator=torch.Generator(),
                        uniforms={k: T(np.stack([u[k] for u in uni])) for k in UNIFORM_KEYS})
    out["loss"].backward()
    for k in ("num_fg_anchors", "num_fg_rois"):
        assert float(out[k]) == float(jm[k]) > 0, k
    for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss"):
        assert abs(float(out[k].detach()) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    ratios = {}
    for name, p in pmodel.named_parameters():
        w = want[name]
        if is_frozen(name, "resnet101") and not ("bn" in name and not name.startswith(
                ("extractor.bn1", "extractor.res2"))):
            assert p.grad is None and not w.any(), name
            continue
        scale = np.abs(w).max()
        if scale == 0:
            continue
        ratios[name] = float(np.abs(p.grad.numpy() - w).max() / scale)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= GRAD_RTOL, (worst, ratios[worst])
    assert np.median(list(ratios.values())) <= 1e-3
    # the head's gradient reached res4 through RoIAlign's backward
    assert ratios["extractor.res4.block23.conv3.weight"] <= GRAD_RTOL
