"""The port's ResNet-101-C4 detect path against the JAX package, on the CPU.

The config, weights and image are those of tests/test_cross_impl_resnet.py
(``_fixture``: JAX-initialised, every bottleneck's conv3 and every FrozenBN
leaf randomised so the residual branches and the BN fold are live, the RPN
and head outputs rescaled); they reach the port through
trcnn_torch.convert.  float32 throughout.  Discrete outputs (proposal
validity, detection validity and classes) must be equal; float outputs
agree within the tolerances stated in each test: about 1e-6 of the
largest magnitude was measured for the features, the RPN and the head, so
1e-4 leaves room for other summation orders.

The JAX side runs two graphs operation by operation: detect (postprocess jitted),
and the trunk, the RPN and the head on fixed RoIs.  ``_fixture`` itself
(a jitted R101 init and three forwards) is built once per test run for
this file and the other ResNet-101 port files (``tests/torch_shared.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from trcnn.models import make_model as jax_make_model
from trcnn.models import resnet as jax_resnet
from trcnn.models.faster_rcnn import cast_params_for_inference as jax_cast
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn_torch.config import voc_config
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.entry import entry
from trcnn_torch.models import cast_params_for_inference, make_model, postprocess
from trcnn_torch.models import resnet
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)
from tests.torch_shared import r101_fixture as shared_fixture

T = torch.from_numpy
FIXED_ROIS = np.stack([np.asarray([10.0, 10.0, 80.0, 90.0]) + 3 * i
                       for i in range(8)])[None].astype(np.float32)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, model, params, images, im_info = shared_fixture(tmp_path_factory)

    # operation by operation: a ResNet-101 graph takes minutes to compile on
    # the CPU, its operations compile once per shape
    def detect(p, x, info):
        raw = model.apply(p, x, info, method="detect")
        return raw, jax.jit(jax_postprocess, static_argnums=2)(raw, info, cfg)

    def trunk(p, x, rois):
        feat = model.apply(p, x, method="features")
        return (feat, model.apply(p, feat, method="rpn_out"),
                model.apply(p, feat, rois, method="roi_forward"))

    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    jraw, jdets = as_np(detect(params, images, im_info))
    jfeat, jrpn, jhead = as_np(trunk(params, images, FIXED_ROIS))

    pmodel = make_model(cfg, device="cpu")
    pmodel.load_state_dict(flax_to_state_dict(params))
    pmodel.eval()
    x, info = T(images), T(im_info)
    with torch.no_grad():
        feat = pmodel.extractor(pmodel._prepare(x, info))
        rpn = pmodel.rpn(feat)
        head = pmodel.roi_forward(T(jfeat), T(FIXED_ROIS))
        raw = pmodel.detect(x, info)
        dets = postprocess(raw, info, cfg)
    return dict(cfg=cfg, params=params, model=pmodel, jraw=jraw, jdets=jdets, jfeat=jfeat,
                jrpn=jrpn, jhead=jhead, feat=feat.numpy(), rpn=[t.numpy() for t in rpn],
                head=[t.numpy() for t in head], raw=[t.numpy() for t in raw],
                dets=[t.numpy() for t in dets])


# ------------------------------------------------------------ the blocks


def _randomise(tree, rng):
    """Random FrozenBN leaves and conv3 kernels (the fixture's recipe)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "mean" in v:
                ch = v["mean"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
                v["mean"] = rng.normal(0, 0.1, ch).astype(np.float32)
                v["bias"] = rng.normal(0, 0.1, ch).astype(np.float32)
            elif k == "conv3":
                v["kernel"] = rng.normal(0, 0.2, v["kernel"].shape).astype(np.float32)
            else:
                _randomise(v, rng)


def _nhwc(fn, x):
    return fn(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("stride,project", [(2, True), (1, False)])
def test_bottleneck_matches_flax(stride, project):
    """A projecting, striding block (odd map: 9 x 11) and an identity one,
    on an input with negative values, random FrozenBN leaves and a live
    conv3: within 1e-5 of the largest output."""
    rng = np.random.default_rng(stride)
    in_ch = 16 if project else 32
    x = (rng.standard_normal((2, 9, 11, in_ch)) * 2).astype(np.float32)
    jm = jax_resnet.Bottleneck(channels=8, stride=stride, project=project)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(stride), x))
    _randomise(params["params"], rng)
    want = np.asarray(jm.apply(params, x))
    block = resnet.Bottleneck(in_ch, 8, stride, project, device="cpu")
    block.load_state_dict(flax_to_state_dict(params))
    got = _nhwc(block, x)
    assert got.shape == want.shape and (want > 0).any()
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_frozen_batch_norm_matches_flax(dtype):
    """The fold in float32, then the multiply and the add each in the
    compute dtype: bit-equal to flax's FrozenBatchNorm in float32 and in
    bf16, on negative and positive inputs."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 6, 24)) * 3).astype(np.float32)
    jm = jax_resnet.FrozenBatchNorm(dtype=dtype)
    leaves = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))["params"]
    tree = {"params": {"bn": leaves}}
    _randomise(tree["params"], rng)
    want = np.asarray(jm.apply({"params": tree["params"]["bn"]}, jnp.asarray(x, dtype)),
                      np.float32)
    bn = resnet.FrozenBatchNorm(24, device="cpu")
    bn.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_state_dict(tree).items()})
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    with torch.no_grad():
        got = bn(T(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_frozen_batch_norm_backward_matches_jax_vjp(dtype):
    """FrozenBatchNorm's written-out backward against ``jax.vjp`` of flax's
    FrozenBatchNorm: dx bit-equal in float32 and bf16 (g times the rounded
    scale, as both autograds give it).  The four float32 leaves' gradients
    within 1e-5 of each leaf's largest: in float32 against JAX's; in bf16
    against the chain rule in float64 on the bf16 products g * x, since
    JAX sums them in bf16 on the CPU (3% of the largest away here) where
    the port sums in float32."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 5, 6, 24)) * 3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = jax_resnet.FrozenBatchNorm(dtype=dtype)
    tree = {"params": {"bn": jax.tree.map(np.asarray,
                                          jm.init(jax.random.PRNGKey(0), x))["params"]}}
    _randomise(tree["params"], rng)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    _, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), tree["params"]["bn"], jx)
    jleaves, jdx = vjp(jg)
    bn = resnet.FrozenBatchNorm(24, device="cpu")
    bn.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_state_dict(tree).items()})
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = T(x).to(tdt).permute(0, 3, 1, 2).detach().requires_grad_(True)
    bn(xt).backward(T(g).to(tdt).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(jdx, np.float32))
    if dtype == jnp.float32:
        want = {k: np.asarray(v, np.float64) for k, v in jleaves.items()}
    else:
        p = {k: np.asarray(v, np.float64) for k, v in tree["params"]["bn"].items()}
        gx = np.asarray(jg * jx, np.float64).sum((0, 1, 2))
        d_shift = np.asarray(jg, np.float64).sum((0, 1, 2))
        std = np.sqrt(p["var"] + 1e-5)
        d_inv = gx - p["mean"] * d_shift
        want = {"scale": d_inv / std, "bias": d_shift, "mean": -p["scale"] / std * d_shift,
                "var": -d_inv * p["scale"] / (2 * std ** 3)}
    for name, w in want.items():
        got = getattr(bn, name).grad.numpy()
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), name


def test_max_pool_pads_with_minus_infinity():
    """3x3/2 padded by one cell: on an all-negative map (odd and even
    sides) the border windows take the largest real cell, not a zero."""
    rng = np.random.default_rng(3)
    for h, w in ((9, 11), (8, 6)):
        x = -np.abs(rng.standard_normal((2, h, w, 5))).astype(np.float32) - 1.0
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                       padding=[(1, 1), (1, 1)]))
        got = _nhwc(resnet.max_pool, x)
        np.testing.assert_array_equal(got, want)
        assert (got < 0).all()


def test_spatial_mean_rounds_as_jnp_mean():
    """The C5 head's mean of bf16 res5 output: bit-equal to ``jnp.mean``
    over the 7 x 7 cells (f32 sum, one division by 49, one rounding to
    bf16).  The values are multiples of 1/64 below 8, so every f32 sum is
    exact in any order and only the division and the rounding are
    compared."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-512, 513, (16, 7, 7, 256)) / 64.0).astype(np.float32)
    want = np.asarray(jnp.mean(jnp.asarray(x, jnp.bfloat16), axis=(1, 2)).astype(jnp.float32))
    got = resnet.spatial_mean(T(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # a multiply by 1/49 in place of the division rounds some means otherwise
    by_reciprocal = (T(x).sum((1, 2)) * np.float32(1 / 49)).to(torch.bfloat16).float().numpy()
    assert (by_reciprocal != want).any()


# ------------------------------------------------------------ the model


def test_init_matches_the_flax_tree(runs):
    """The port's parameters are the flax tree's leaves, name for name and
    shape for shape; the seeded init zeroes every conv3, makes each
    FrozenBN the identity (its leaves take gradients, as JAX's do), and
    gives no convolution a bias."""
    cfg, params = runs["cfg"], runs["params"]
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    want = flax_to_state_dict(params)
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == torch.float32, k
    fill = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}
    n_bn = 0
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)
        if "bn" in leaf[0].rsplit(".", 1)[-1]:
            n_bn += 1
            assert p.requires_grad and torch.all(p == fill[leaf[1]]), name   # differentiated
        elif leaf[0].endswith("conv3"):
            assert not p.any(), name
        elif leaf[1] == "weight" and p.dim() == 4 and not name.startswith("rpn"):
            assert p.std() > 0 and f"{leaf[0]}.bias" not in sd, name
    assert n_bn == 4 * 104       # bn1 + 33 + 3 blocks x 3 BNs + 4 projections


def test_c4_features_match_jax(runs):
    assert runs["feat"].shape == (1, 8, 12, 1024)
    assert _rel_err(runs["feat"], runs["jfeat"]) < 1e-4


def test_rpn_outputs_match_jax(runs):
    jrpn = runs["jrpn"]
    for got, want in zip(runs["rpn"], (jrpn.fg_probs, jrpn.logits, jrpn.deltas)):
        assert got.shape == want.shape
        assert _rel_err(got, want) < 1e-4


def test_proposals_match_jax(runs):
    """The same proposals in the same order; coordinates within 1e-4
    pixels (the decode's exp may differ by an ulp)."""
    rois, roi_valid = runs["raw"][:2]
    np.testing.assert_array_equal(roi_valid, runs["jraw"].roi_valid)
    assert roi_valid.sum() == runs["cfg"].proposals.post_nms_topk_test
    np.testing.assert_allclose(rois, runs["jraw"].rois, rtol=1e-6, atol=1e-4)


def test_c5_head_matches_jax(runs):
    """res5 on the 14 x 14 crops of fixed RoIs, the spatial mean and the
    float32 output layers, on JAX's own features."""
    for got, want in zip(runs["head"], runs["jhead"]):
        assert got.shape == want.shape
        assert _rel_err(got, want) < 1e-4


def test_detections_match_jax(runs):
    jraw, jdets = runs["jraw"], runs["jdets"]
    cls_prob, bbox_pred = runs["raw"][2:]
    assert _rel_err(cls_prob, jraw.cls_prob) < 1e-4
    assert _rel_err(bbox_pred, jraw.bbox_pred) < 1e-4
    boxes, scores, classes, valid = runs["dets"]
    np.testing.assert_array_equal(valid, jdets.valid)
    assert valid.sum() > 3
    np.testing.assert_array_equal(classes, jdets.classes)
    np.testing.assert_allclose(scores, jdets.scores, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(boxes, jdets.boxes, rtol=1e-4, atol=1e-3)


def test_bridge_round_trip_is_exact(runs):
    """flax tree -> state_dict -> flax tree is exact, the FrozenBN leaves
    and the bias-free convolutions included."""
    tree, model = runs["params"], runs["model"]
    back = state_dict_to_flax(flax_to_state_dict(tree))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert flat_back[k].dtype == v.dtype
        np.testing.assert_array_equal(flat_back[k], v)
    bn = tree["params"]["extractor"]["res3"]["block1"]["proj_bn"]
    sd = model.state_dict()
    for leaf in ("scale", "bias", "mean", "var"):
        np.testing.assert_array_equal(sd[f"extractor.res3.block1.proj_bn.{leaf}"].numpy(),
                                      bn[leaf])
    assert "extractor.res3.block1.conv2.bias" not in sd


def test_cast_for_inference_keeps_frozen_bn_and_islands_f32(runs):
    """bf16 serving cast: every conv weight narrowed, the FrozenBN leaves,
    the RPN biases and cls_score / bbox_pred stay float32, as the JAX
    package's cast leaves them."""
    cfg, params = runs["cfg"], runs["params"]
    model = make_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    cast_params_for_inference(model, torch.bfloat16)
    marks = flax_to_state_dict(jax.tree.map(lambda a: np.full(a.shape, a.dtype == jnp.bfloat16),
                                            jax_cast(params, jnp.bfloat16)))
    narrowed = {k for k, v in model.state_dict().items() if v.dtype == torch.bfloat16}
    assert narrowed == {k for k, v in marks.items() if v.all()}
    assert any(k.endswith("bn3.var") for k in model.state_dict())
    assert model.head.cls_score.weight.dtype == torch.float32
    assert model.extractor.res4.block23.conv2.weight.dtype == torch.bfloat16


def test_entry_resnet101_small_config_on_cpu():
    """``entry`` at the R101 small config on the CPU: finite detections of
    the configured capacity; the backbone switch builds the VOC R101 config
    and refuses a config that names another backbone.  float32: bf16
    convolutions on a CPU shared by several test workers are slow, and the
    bf16 rounding is held by test_frozen_batch_norm_matches_flax and on the
    card."""
    from tests.test_cross_impl_resnet import _cfg

    cfg = _cfg()
    fn, (model, image, info) = entry("cpu", cfg=cfg, dtype=torch.float32, backbone="resnet101")
    assert model.pool_size == 14 and model.rpn.rpn_conv.in_channels == 1024
    dets = fn(model, image, info)
    d = cfg.test.max_dets_per_image
    assert dets.boxes.shape == (1, d, 4) and torch.isfinite(dets.boxes).all()
    with pytest.raises(ValueError):
        entry("cpu", cfg=cfg, backbone="vgg16")
    assert voc_config().replace(backbone="resnet101").roi.output_size * 2 == 14
