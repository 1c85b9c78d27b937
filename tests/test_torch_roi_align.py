"""The port's RoIAlign (``RoIConfig.mode="align"``) against the JAX package,
on the CPU: the plain forward and backward (the spec kernels K5 and K6 are
held to on the card), and the VGG-16 model with RoIAlign, detect and one
training step.

Tolerances, with what was measured:
  * forward: bit-equal to JAX's formulation run operation by operation
    (``jax.disable_jit``, the same float32 products and sums in the same
    order), and with ``out_dtype=torch.bfloat16`` bit-equal to that output
    rounded to bfloat16 (numpy's cast, round to nearest even); within 1e-5
    of the largest output against the jitted JAX function, whose fused
    loops contract or reorder some of them: a sample coordinate that
    rounds the other way moves its fraction by an ulp of the coordinate
    (2^-20 on a 13-cell map), and the value by that times the difference
    of two neighbouring cells (measured 2e-6 relative); so in bfloat16
    within one bf16 ulp of the jitted output cast (at P=14, 7-8 of 21560
    elements round the other way);
  * backward, float32: within 1e-5 of the largest |dfeat|: the scatter
    adds in another order, and the RoI beyond the map sends all its
    P^2 s^2 samples (784 at P=14) to one cell (measured 3.3e-6);
  * backward, bfloat16: the port sums in float32 and rounds once, so its
    bf16 gradient is the float32 one rounded (bit-equal) and at least as
    close to JAX's float32 gradient as JAX's own bf16 gradient is (JAX
    rounds every corner's cotangent to bf16 and scatter-adds in bf16:
    measured 3-7% of the largest |dfeat| off its float32 gradient);
    against JAX's bf16 gradient the port is held to 10% of the largest
    |dfeat|, the loose tolerance that rounding allows;
  * the VGG-16 model: proposals equal, cls_prob and bbox_pred within 1e-4
    relative, detections' validity and classes equal; one training step's
    sampled counts equal, losses within 1e-4 relative, gradients within
    1e-3 of each trained tensor's largest JAX gradient, as the port's
    max-pool training test holds them (measured: 6.3e-4 in conv4_1, the
    median 1e-6; the float32 forwards differ in their last bits and move a
    few ReLU and pooling decisions).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_impl_train import B, _derive_uniforms, _geom, _sampling_rng
from tests.torch_shared import vgg_train_fixture
from trcnn.config import FasterRCNNConfig, ProposalConfig
from trcnn.models import make_model as jax_make_model
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn.ops.roi_align import roi_align as jax_roi_align
from trcnn.ops.roi_align import roi_align_batched
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.models import make_model, postprocess
from trcnn_torch.models.faster_rcnn import UNIFORM_KEYS
from trcnn_torch.ops import roi_align
from trcnn_torch.train.optim import is_frozen
from trcnn_torch.train.step import BATCH_KEYS
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _align(cfg):
    return cfg.replace(roi=dataclasses.replace(cfg.roi, mode="align"))


def _case(seed, b=2, r=11, h=9, w=13, c=5):
    """Random RoIs, one beyond the map (every sample clipped to the last
    cell), one larger than it on all sides, one under one cell and one of
    zero size (``max(., 1)``), in image coordinates at stride 16."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x1 = rng.uniform(-40, w * 16, (b, r))
    y1 = rng.uniform(-40, h * 16, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 200, (b, r)),
                     y1 + rng.uniform(0, 150, (b, r))], -1)
    rois[:, 0] = (w * 16 + 30, h * 16 + 30, w * 16 + 90, h * 16 + 70)
    rois[:, 1] = (-100, -100, w * 16 + 200, h * 16 + 150)
    rois[:, 2] = (37, 21, 45, 25)
    rois[:, 3] = (80, 48, 80, 48)
    return feat, rois.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(p, dtype):
    """JAX's RoIAlign of ``_case(p)`` in ``dtype``: the jitted function's
    output and the op-by-op run's, both float32 numpy (one compile and one
    op-by-op run per case, shared by the output dtypes)."""
    jdt = DTYPES[dtype][0]
    feat, rois = _case(p)
    jfeat = jnp.asarray(feat).astype(jdt)
    want = np.asarray(roi_align_batched(jfeat, jnp.asarray(rois), out_size=p))
    with jax.disable_jit():
        exact = np.stack([np.asarray(jax_roi_align(jfeat[i], jnp.asarray(rois[i]), out_size=p))
                          for i in range(len(rois))])
    return want, exact


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [7, 14])
def test_plain_forward_matches_jax(p, dtype, out):
    tdt = DTYPES[dtype][1]
    feat, rois = _case(p)
    want, exact = _jax_forward(p, dtype)
    got = roi_align.roi_align_plain(T(feat).to(tdt), T(rois), p, out_dtype=DTYPES[out][1])
    assert got.dtype == DTYPES[out][1] and want.dtype == np.float32
    if out == "float32":
        np.testing.assert_array_equal(got.numpy(), exact)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    else:
        # the float32 mean rounded once, as JAX's output cast to bfloat16
        bits = got.view(torch.int16).numpy()
        np.testing.assert_array_equal(bits, exact.astype(jnp.bfloat16).view(np.int16))
        jitted = want.astype(jnp.bfloat16).view(np.int16)
        assert np.abs(bits.astype(np.int32) - jitted).max() <= 1
    # chunking changes nothing
    assert torch.equal(roi_align.roi_align_plain(T(feat).to(tdt), T(rois), p,
                                                 out_dtype=DTYPES[out][1], chunk=3), got)


def _jax_vjp(feat, rois, g, p, jdt):
    _, vjp = jax.vjp(lambda f: roi_align_batched(f, jnp.asarray(rois), out_size=p),
                     jnp.asarray(feat).astype(jdt))
    return np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))


@pytest.mark.parametrize("p", [7, 14])
def test_plain_backward_matches_jax_vjp(p):
    feat, rois = _case(10 + p)
    g = np.random.default_rng(p).standard_normal(rois.shape[:2] + (p, p, 5)).astype(np.float32)
    want32 = _jax_vjp(feat, rois, g, p, jnp.float32)
    want16 = _jax_vjp(feat, rois, g, p, jnp.bfloat16)
    got32 = roi_align.roi_align_backward_plain(feat.shape, torch.float32, T(rois), T(g), p,
                                               chunk=4)
    got16 = roi_align.roi_align_backward_plain(feat.shape, torch.bfloat16, T(rois), T(g), p,
                                               chunk=4)
    scale = np.abs(want32).max()
    assert np.abs(got32.numpy() - want32).max() <= 1e-5 * scale
    assert torch.equal(got16, got32.to(torch.bfloat16))
    port_err = np.abs(got16.float().numpy() - want32).max()
    jax_err = np.abs(want16 - want32).max()
    assert port_err <= jax_err, (port_err, jax_err)
    assert np.abs(got16.float().numpy() - want16).max() <= 0.1 * scale
    # mass: every sample's weights sum to one, so dfeat sums to g's sum
    assert np.isclose(got32.sum().item(), g.sum(), rtol=1e-4)


def test_autograd_function_routes_to_the_plain_backward():
    feat, rois = _case(3)
    f = T(feat).requires_grad_()
    r = T(rois).requires_grad_()
    out = roi_align.roi_align(f, r, 7)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    assert r.grad is None
    want = roi_align.roi_align_backward_plain(feat.shape, torch.float32, T(rois), g, 7)
    assert torch.equal(f.grad, want)
    # bf16 feat: the gradient comes back in bf16
    fb = T(feat).to(torch.bfloat16).requires_grad_()
    roi_align.roi_align(fb, T(rois), 7).backward(g)
    assert fb.grad.dtype == torch.bfloat16
    assert torch.equal(fb.grad, want.to(torch.bfloat16))


def test_bf16_output_gradient_equals_the_cast_route():
    """roi_align(..., out_dtype=bfloat16) against the float32 output cast
    to bfloat16 (the heads' route before the output dtype): the same
    crops and, through autograd, the same bf16 cotangent reaching the
    backward (the cast's backward upcast it exactly) and the same dfeat."""
    feat, rois = _case(5)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        rois.shape[:2] + (7, 7, 5)).astype(np.float32)).to(torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        direct = T(feat).to(dt).requires_grad_()
        cast = T(feat).to(dt).requires_grad_()
        out = roi_align.roi_align(direct, T(rois), 7, out_dtype=torch.bfloat16)
        ref = roi_align.roi_align(cast, T(rois), 7).to(torch.bfloat16)
        assert out.dtype == ref.dtype == torch.bfloat16
        assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
        out.backward(g)
        ref.backward(g)
        assert direct.grad.dtype == dt
        assert torch.equal(direct.grad, cast.grad)


@pytest.mark.parametrize("h,w,c", [(38, 64, 512), (50, 84, 1024), (84, 50, 1024),
                                   (40, 64, 1024), (300, 90, 512), (9, 13, 36), (7, 9, 3),
                                   (21, 30, 40), (64, 3000, 2048), (21, 30, 768),
                                   (17, 25, 520)])
def test_backward_plan_fits_every_map(h, w, c):
    """K6's tiling (``_bwd_plan``): a slab of at most SLAB_BYTES, at most
    256 threads a block, channel slices that are whole vectors (multiples
    of 8 on the vector path), tiles within the map that cover it."""
    for vec in (True, False) if c % 8 == 0 else (False,):
        v, cc, ty, tx, smem = roi_align._bwd_plan(h, w, c, vec)
        assert (v in (4, 2) and cc % 8 == 0) if vec else v == 1
        assert 1 <= cc <= c and -(-cc // v) <= 256 and cc % v == 0
        assert 1 <= ty <= h and 1 <= tx <= w
        assert smem == ty * tx * cc * 4 <= max(roi_align.SLAB_BYTES, cc * 4)


# ------------------------------------------------------------ the model


def _detect_cfg():
    """tests/test_torch_slice.py's config (test_golden_e2e's), RoIAlign."""
    return _align(FasterRCNNConfig(
        head_hidden=32, rpn_channels=16,
        proposals=ProposalConfig(pre_nms_topk_test=192, post_nms_topk_test=24,
                                 pre_nms_topk_train=192, post_nms_topk_train=48)))


def test_vgg16_align_detections_match_jax():
    cfg = _detect_cfg()
    jmodel = jax_make_model(cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    images = jax.random.uniform(k1, (1, 64, 96, 3)) * 120.0 - 60.0
    im_info = jnp.asarray([[60.0, 90.0, 1.2]], jnp.float32)
    params = jax.jit(jmodel.init)(k2, images, im_info)

    @jax.jit
    def detect(p, x, info):
        raw = jmodel.apply(p, x, info, method="detect")
        return raw, jax_postprocess(raw, info, cfg, score_thresh=0.02)

    jraw, jdets = jax.tree.map(np.asarray, detect(params, images, im_info))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    x, info = T(np.array(images)), T(np.array(im_info))
    with torch.no_grad():
        raw = model.detect(x, info)
        dets = postprocess(raw, info, cfg, score_thresh=0.02)
    np.testing.assert_array_equal(raw.roi_valid.numpy(), jraw.roi_valid)
    np.testing.assert_allclose(raw.rois.numpy(), jraw.rois, rtol=1e-6, atol=1e-4)
    for got, want in ((raw.cls_prob, jraw.cls_prob), (raw.bbox_pred, jraw.bbox_pred)):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(dets.valid.numpy(), jdets.valid)
    assert jdets.valid.sum() > 0
    np.testing.assert_array_equal(dets.classes.numpy(), jdets.classes)
    np.testing.assert_allclose(dets.scores.numpy(), jdets.scores, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dets.boxes.numpy(), jdets.boxes, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """tests/test_cross_impl_train.py's fixture with RoIAlign: JAX's losses
    and gradients from one value_and_grad, and the port's from the same
    parameters and sampling draws."""
    cfg, _, params, images, im_info, (gtb, gtl, gtv) = vgg_train_fixture(tmp_path_factory)
    cfg = _align(cfg)
    model = jax_make_model(cfg, dtype=jnp.float32)
    fh, fw, n, n_cand = _geom(cfg)
    batch = {"images": images, "im_info": im_info, "gt_boxes": gtb, "gt_labels": gtl,
             "gt_valid": gtv}
    jbatch = [jnp.asarray(batch[k]) for k in BATCH_KEYS]
    drop, samp = jax.random.split(jax.random.PRNGKey(11))

    def loss_fn(p):
        out = model.apply(p, *jbatch, method="losses", rngs={"dropout": drop, "sampling": samp})
        return out["loss"], out

    (_, jmetrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _, _, uni = _derive_uniforms(_sampling_rng(model, params, samp), B, n, n_cand)
    uniforms = {k: T(np.stack([u[k] for u in uni])) for k in UNIFORM_KEYS}
    pmodel = make_model(cfg, device="cpu")
    pmodel.load_state_dict(flax_to_state_dict(params))
    pmodel.train()
    out = pmodel.losses(*(T(np.array(batch[k])) for k in BATCH_KEYS),
                        generator=torch.Generator(), uniforms=uniforms)
    out["loss"].backward()
    return dict(jax_metrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v.detach()) for k, v in out.items()},
                jax_grads={k: v.numpy() for k, v in flax_to_state_dict(
                    jax.tree.map(np.asarray, grads)).items()},
                grads={k: None if p.grad is None else p.grad.numpy()
                       for k, p in pmodel.named_parameters()})


def test_vgg16_align_training_losses_match_jax(train_run):
    j, p = train_run["jax_metrics"], train_run["metrics"]
    assert p["num_fg_anchors"] == j["num_fg_anchors"] > 0
    assert p["num_fg_rois"] == j["num_fg_rois"] > 0
    for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss"):
        assert abs(p[k] - j[k]) <= 1e-4 * abs(j[k]), (k, p[k], j[k])


def test_vgg16_align_gradients_match_jax(train_run):
    grads, want = train_run["grads"], train_run["jax_grads"]
    ratios = {}
    for name, w in want.items():
        if is_frozen(name):
            assert grads[name] is None and not w.any(), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        ratios[name] = float(np.abs(grads[name] - w).max() / scale)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1e-3, (worst, ratios[worst])
    # the gradient reached the trunk through RoIAlign's backward
    assert ratios["extractor.conv5_3.weight"] <= 1e-3


# ------------------------------------------------------------ special maps and modes


def test_constant_map_and_linear_ramp():
    """tests/test_roi_pool.py's two RoIAlign cases through the port, and
    the same inputs through JAX: a constant map gives the constant; a ramp
    along x gives the bins' sample centres exactly, away from the border."""
    rng = np.random.RandomState(0)
    feat = np.full((1, 12, 12, 3), 2.5, np.float32)
    xy = rng.uniform(0, 150, (5, 2))
    wh = rng.uniform(8, 60, (5, 2))
    rois = np.concatenate([xy, xy + wh], 1)[None].astype(np.float32)
    got = roi_align.roi_align_plain(T(feat), T(rois)).numpy()
    np.testing.assert_allclose(got, 2.5, rtol=1e-5)
    ramp = np.arange(16, dtype=np.float32)[None, :].repeat(16, 0)[None, ..., None]
    box = np.array([[[32.0, 32.0, 160.0, 160.0]]], np.float32)
    got = roi_align.roi_align_plain(T(ramp), T(box)).numpy()[0, 0, ..., 0]
    expect = 2.0 + (np.arange(7) + 0.5) * (8.0 / 7)
    np.testing.assert_allclose(got.mean(axis=0), expect, rtol=1e-5)
    want = np.asarray(roi_align_batched(jnp.asarray(ramp), jnp.asarray(box)))[0, 0, ..., 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_unknown_roi_mode_is_refused():
    cfg = FasterRCNNConfig()
    with pytest.raises(ValueError, match="RoI mode"):
        make_model(cfg.replace(roi=dataclasses.replace(cfg.roi, mode="bilinear")), device="cpu")
