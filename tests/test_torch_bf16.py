"""The port in the dtype it ships, bfloat16 compute with float32 parameters
and float32 islands, against the JAX package's bfloat16 graph on the CPU.

Detect runs stage by stage: each stage of the port receives JAX's output
of the stage before it, so a difference is pinned to one stage.  VGG-16 on
tests/test_cross_impl.py's calibrated weights (``_fixture``) with random
biases, on two uint8 canvases with different ``im_info`` rows; ResNet-101-
C4 on tests/test_cross_impl_resnet.py's weights (``tests/torch_shared.py``).  The
training step runs VGG-16 on tests/test_cross_impl_train.py's fixture and
sampling draws (float32 parameters, bfloat16 compute, as ``train_entry``
trains); ResNet-101's bf16 training step is held card against CPU in
chip_smoke.py (JAX's bf16 gradient of it costs over two minutes here).

Limits (tests/bf16_limits.py derives them).  Both sides round each
convolution and matmul to bf16 from a float32 accumulation, then add the
bias in bf16 (flax's order); oneDNN and Eigen sum in other orders.  Every
layer (a VGG-16 convolution, a ResNet-101 bottleneck, the RPN, a head) is
held as a *stage* from JAX's own input to it: its rms difference within a
quarter of one independent bf16 rounding on each side (``STAGE_RMS``
rho), its largest within the first-order bound for its ``r`` rounding
points (at most 10).  The trunk from its input, and detect end to end, are
*chains*: within twice the largest, and sqrt(2) times the rms, distance of
the port's float32 run of the same graph from JAX's bf16 output.  The stem
is held to K3's own limit against its plain version, one ulp of its scale
(``chip_smoke.stem_limit``).  Float32 stages on equal inputs (proposals,
the epilogue) and the RoI max pool are exact: the same decisions, the same
boxes up to the decode's exp (1e-4 px) and the epilogue's limits of
tests/test_torch_coco.py.  :func:`test_limits_fail_rounding_faults` runs
the port with one rounding fewer at every layer and with bf16 sums, and
asserts that every stage, and the chains, fail their limits under them.

The rounding order itself is held exactly: on integer-valued inputs and
weights every float32 sum is exact in any order, so each layer kind (a
convolution with its bias, the RPN, fc6/fc7 and the float32 islands, a
bottleneck with its FrozenBNs) must be bit-equal to flax's; a bias folded
into the convolution, or a cast in another place, rounds once less or once
more and fails there.

JAX's side runs operation by operation, each op rounding where flax
writes it (:func:`jax_stages`).  Jitted on the CPU, XLA drops a bf16
rounding that a float32 cast follows (its ``allow_excess_precision``):
the RPN's logits and deltas then come out of the convolution and bias in
float32, within half a bf16 ulp of flax's order, which the port keeps.
The training step's JAX gradient is jitted (its limits hold either way).

End to end, a discrete output may differ where JAX's own values put the
decision within the stage's limit of its threshold (a score tied at the
top-k cut, an IoU at the NMS threshold); the test computes that margin
from JAX's values and asserts it, and any other difference fails.
"""

import contextlib
import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flax import linen as fnn

from tests.torch_shared import r101_fixture, vgg_detect_fixture, vgg_train_fixture
from trcnn.models import resnet as jax_resnet
from trcnn.models import roi_head as jax_roi_head
from trcnn.models import rpn as jax_rpn
from trcnn.models import make_model as jax_make_model
from trcnn.models.faster_rcnn import RawDetections as JaxRaw
from trcnn.models.faster_rcnn import cast_params_for_inference as jax_cast
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn.ops.proposal import proposal_layer as jax_proposal_layer
from trcnn.ops.roi_align import roi_align_batched
from trcnn.ops.roi_pool import roi_max_pool as jax_roi_max_pool
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.models import cast_params_for_inference, make_model, postprocess
from trcnn_torch.models import resnet, roi_head, rpn, vgg16
from trcnn_torch.models.faster_rcnn import RawDetections
from trcnn_torch.ops.proposal import proposal_layer
from trcnn_torch.ops.roi_pool import roi_max_pool
from trcnn_torch.ops.stem import stem_block1_plain
from tests.bf16_limits import (GRAD_CAP, STAGE_RMS, Bf16Accumulation, Props, bf16_ulp, chain,
                               chain_limits, compare_detect, fused_rounding, gradient_chains, lam,
                               loss_limits, proposal_flips, stage, ulps, within)
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy
BF16 = torch.bfloat16
INFO = np.asarray([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]], np.float32)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


def _bf(x):
    return T(np.asarray(x, np.float32)).to(BF16)


def _nchw_pool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ------------------------------------------------------------ VGG-16 detect

VGG_BLOCKS = (("conv2", 2), ("conv3", 3), ("conv4", 3), ("conv5", 3))


def _uint8_canvases(rng, b, h, w):
    return np.clip(np.round(rng.standard_normal((b, h, w, 3)) * 40.0 + 115.0),
                   0, 255).astype(np.uint8)


def _random_biases(tree, rng, scale=0.1):
    for k, v in tree.items():
        if isinstance(v, dict):
            _random_biases(v, rng, scale)
        elif k == "bias" and v.ndim == 1:
            tree[k] = (rng.standard_normal(v.shape) * scale).astype(np.float32)


def jax_stages(cfg, params, images, info, base=None):
    """JAX's bf16 detect stage by stage, through the model's own stage
    methods (``_prepare``, ``features`` with the trunk's layers' and
    bottlenecks' outputs captured, ``rpn_out``, the proposal layer, the RoI
    max pool or RoIAlign as the config says, ``roi_forward`` with res5's
    bottlenecks' outputs captured, the softmax and ``postprocess``), after
    ``cast_params_for_inference``; float32 numpy out.  The model's layers
    run operation by operation, each rounding where flax writes it (a
    ResNet-101 graph takes minutes to compile on the CPU; its operations
    compile once per shape), the proposal layer and the epilogue jitted.
    ``base``: an earlier result for the same weights and canvases, whose
    trunk, RPN and proposals are taken as they are (another RoI mode)."""
    jm = jax_make_model(cfg, dtype=jnp.bfloat16)
    p = jax_cast(params, jnp.bfloat16)
    p_out = 2 * cfg.roi.output_size if cfg.backbone == "resnet101" else cfg.roi.output_size
    if base is None:
        propose = jax.jit(jax.vmap(lambda f, d, i: jax_proposal_layer(
            f, d, i[0], i[1], i[2], train=False, anchor_cfg=cfg.anchors, cfg=cfg.proposals)))
        prep = jm.apply(p, images, info, method="_prepare")
        feat, inter = jm.apply(p, prep, method="features",
                               capture_intermediates=lambda m, _: 2 <= len(m.scope.path) <= 3)
        rpn = jm.apply(p, feat, method="rpn_out")
        props = propose(rpn.fg_probs, rpn.deltas, jnp.asarray(info))
        inter = inter["intermediates"]["extractor"]
        trunk = {k: v["__call__"][0] for k, v in inter.items() if k != "__call__"}
        # ResNet-101's bottlenecks' outputs, "res4/block7"
        trunk.update({f"{k}/{b}": w["__call__"][0] for k, v in inter.items()
                      if k != "__call__" for b, w in v.items() if b.startswith("block")})
        out = dict(prep=prep, trunk=trunk, feat=feat, rpn=rpn, rois=props.rois,
                   roi_valid=props.valid)
    else:
        out = {k: base[k] for k in ("prep", "trunk", "feat", "rpn", "rois", "roi_valid")}
        feat = jnp.asarray(base["feat"], jnp.bfloat16)
        props = SimpleNamespace(rois=jnp.asarray(base["rois"]),
                                valid=jnp.asarray(base["roi_valid"]))
    if cfg.roi.mode == "align":
        pooled = jax.jit(functools.partial(roi_align_batched, out_size=p_out,
                                           spatial_scale=cfg.roi.spatial_scale))(feat, props.rois)
    else:
        pooled = jax.jit(jax.vmap(lambda f, r: jax_roi_max_pool(
            f, r, p_out, cfg.roi.spatial_scale)))(feat, props.rois)
    (cls_score, bbox_pred), inter = jm.apply(
        p, feat, props.rois, method="roi_forward",
        capture_intermediates=lambda m, _: len(m.scope.path) == 3 and m.scope.path[1] == "res5")
    res5 = inter.get("intermediates", {}).get("head", {}).get("res5", {})
    raw = JaxRaw(rois=props.rois, roi_valid=props.valid,
                 cls_prob=jax.nn.softmax(cls_score, axis=-1), bbox_pred=bbox_pred)
    out.update(pooled=pooled, cls_score=cls_score, raw=raw,
               res5={k: v["__call__"][0] for k, v in res5.items()},
               dets=jax.jit(functools.partial(jax_postprocess, cfg=cfg))(raw, jnp.asarray(info)))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                             else a), out)


def port_model(cfg, params, dtype=BF16):
    """The port's model with JAX's weights: bf16 after
    ``cast_params_for_inference``, or the float32 run of the same graph."""
    pm = make_model(cfg, dtype=dtype, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params))
    return cast_params_for_inference(pm.eval(), BF16) if dtype == BF16 else pm.eval()


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    """tests/test_cross_impl.py's calibrated VGG-16 with random biases, two
    uint8 canvases, JAX's stages (:func:`jax_stages`) and the port's
    bf16 and float32 models with the same weights."""
    cfg, _, params, _, _ = vgg_detect_fixture(tmp_path_factory)
    rng = np.random.default_rng(13)
    params = jax.tree.map(np.array, params)
    _random_biases(params["params"]["extractor"], rng)
    _random_biases(params["params"]["rpn"], rng, 0.02)
    _random_biases(params["params"]["head"], rng, 0.02)
    images = _uint8_canvases(rng, 2, cfg.image.pad_h, cfg.image.pad_w)
    return dict(cfg=cfg, j=jax_stages(cfg, params, images, INFO), model=port_model(cfg, params),
                f32=port_model(cfg, params, torch.float32), images=images, info=INFO,
                params=params)


def _vgg_stem(j):
    return _nchw_pool(torch.relu(_bf(j["trunk"]["conv1_2"])))


def _vgg_block_out(j, name, n):
    return torch.relu(_bf(j["trunk"][f"{name}_{n}"]))


def _port_blocks(e, x, blocks):
    """The port's trunk from conv2_1 on, as ``VGG16.forward`` runs it, on an
    NHWC input; ``blocks`` of VGG_BLOCKS (a pool before every block but
    conv2)."""
    x = x.permute(0, 3, 1, 2)
    for name, n in blocks:
        if name != "conv2":
            x = F.max_pool2d(x, 2, 2)
        for ci in range(n):
            x = e._conv(x, getattr(e, f"{name}_{ci + 1}"))
    return x.permute(0, 2, 3, 1)


def vgg_stages(case, pm, check=True):
    """Every VGG-16 stage from JAX's input to it (:func:`stage`): each
    convolution from conv2_1 to conv5_3 (r=2: the convolution and its
    bias), the RPN from JAX's features (logits and deltas, r=4) and the
    head from JAX's pooled crops (fc6 and fc7 with their biases, r=4, then
    the float32 cls_score and bbox_pred).  Returns each stage's (largest
    difference in ulps, rms in rho)."""
    j, e, out = case["j"], pm.extractor, {}
    with torch.no_grad():
        x = _vgg_stem(j)
        for name, n in VGG_BLOCKS:
            for ci in range(n):
                layer = f"{name}_{ci + 1}"
                xin = x.permute(0, 3, 1, 2)
                if ci == 0 and name != "conv2":
                    xin = F.max_pool2d(xin, 2, 2)
                got = e._conv(xin, getattr(e, layer)).permute(0, 2, 3, 1)
                x = _vgg_block_out(j, name, ci + 1)
                out[layer] = stage(layer, got, x, 2, check)
        rpn = pm.rpn(_bf(j["feat"]))
        for k in ("logits", "deltas"):
            out[f"rpn {k}"] = stage(f"rpn {k}", getattr(rpn, k), getattr(j["rpn"], k), 4, check)
        out.update(_head_stage(j, pm, 4, check))
    return out


def _head_stage(j, pm, r, check):
    b, n = j["rois"].shape[:2]
    cls_score, bbox_pred = pm.head(_bf(j["pooled"]).reshape((b * n,) + j["pooled"].shape[2:]))
    return {"head cls_score": stage("head cls_score", cls_score, j["cls_score"].reshape(b * n, -1),
                                    r, check),
            "head bbox_pred": stage("head bbox_pred", bbox_pred,
                                    j["raw"].bbox_pred.reshape(b * n, -1), r, check)}


def chains(case, pm, check=True):
    """The chains (:func:`chain`, against the float32 run ``case["f32"]``):
    the trunk from its input (VGG-16: conv2_1 to conv5_3 from JAX's stem
    output; ResNet-101: from JAX's prepared canvas), and from the canvas
    the RPN's logits and deltas and cls_score on JAX's proposals.
    Returns each one's (largest, rms) fractions of its limits."""
    j, out = case["j"], {}
    with torch.no_grad():
        feats = []
        for m in (pm, case["f32"]):
            if case["cfg"].backbone == "resnet101":
                feats.append(m.extractor(T(j["prep"])))
            else:
                feats.append(_port_blocks(m.extractor, _vgg_stem(j).to(m.extractor.dtype),
                                          VGG_BLOCKS))
        out["trunk"] = chain("trunk", feats[0], j["feat"], feats[1], check)
        x, inf = T(case["images"]), T(case["info"])
        feats = [m.extractor(m._prepare(x, inf)) for m in (pm, case["f32"])]
        rpns = [m.rpn(f) for m, f in zip((pm, case["f32"]), feats)]
        for k in ("logits", "deltas"):
            out[k] = chain(f"rpn {k}", getattr(rpns[0], k), getattr(j["rpn"], k),
                           getattr(rpns[1], k), check)
        cs = [m.roi_forward(f, T(j["rois"]))[0] for m, f in zip((pm, case["f32"]), feats)]
        out["cls_score"] = chain("cls_score", cs[0], j["cls_score"], cs[1], check)
    return out


def test_vgg16_trunk_stages_match_jax(vgg):
    """``_prepare`` bit-equal; the stem (conv1_1, conv1_2, pool1) from
    JAX's prepared canvas within K3's limit; every stage
    (:func:`vgg_stages`) and the chains (:func:`chains`)."""
    j, pm, e = vgg["j"], vgg["model"], vgg["model"].extractor
    with torch.no_grad():
        prep = pm._prepare(T(vgg["images"]), T(INFO))
        np.testing.assert_array_equal(prep.numpy(), j["prep"])
        stem = stem_block1_plain(T(j["prep"]).to(BF16).contiguous(), e.conv1_1.weight,
                                 e.conv1_1.bias, e.conv1_2.weight, e.conv1_2.bias)
        want = _np(_vgg_stem(j))
        u_stem = within("stem", _np(stem), want, float(bf16_ulp(np.abs(want).max())))
    print("VGG-16 bf16 stem", u_stem, "ulps; stages (ulps, rms in rho):", vgg_stages(vgg, pm),
          "; chains (fractions of the limits):", chains(vgg, pm))


def head_stages(j, pm, info):
    """From JAX's RPN tensors, features, RoIs and head outputs: the
    proposals (validity, boxes, order) exact; the RoI max pool bit-equal;
    the softmax of JAX's cls_score as JAX's within 1e-6; the epilogue's
    classes, validity and keep set exact, boxes and scores within the
    float32 limits of tests/test_torch_coco.py."""
    cfg = pm.cfg
    with torch.no_grad():
        props = proposal_layer(T(j["rpn"].fg_probs), T(j["rpn"].deltas), T(info[:, 0]),
                               T(info[:, 1]), T(info[:, 2]), train=False,
                               anchor_cfg=cfg.anchors, cfg=cfg.proposals)
        np.testing.assert_array_equal(props.valid.numpy(), j["roi_valid"])
        assert j["roi_valid"].sum() > 0
        np.testing.assert_allclose(props.rois.numpy(), j["rois"], rtol=1e-6, atol=1e-4)
        pooled = roi_max_pool(_bf(j["feat"]), T(j["rois"]), pm.pool_size,
                              cfg.roi.spatial_scale)
        assert pooled.dtype == BF16
        np.testing.assert_array_equal(_np(pooled), j["pooled"])
        np.testing.assert_allclose(torch.softmax(T(j["cls_score"]), -1).numpy(),
                                   j["raw"].cls_prob, rtol=0, atol=1e-6)
        raw = RawDetections(*(T(np.array(a)) for a in j["raw"]))
        dets = [t.numpy() for t in postprocess(raw, T(info), cfg)]
    want = j["dets"]
    np.testing.assert_array_equal(dets[3], want.valid)
    assert want.valid.sum() > 3
    np.testing.assert_array_equal(dets[2], want.classes)
    np.testing.assert_allclose(dets[1], want.scores, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dets[0], want.boxes, rtol=1e-5, atol=1e-3)


def test_vgg16_head_stages_match_jax(vgg):
    """:func:`head_stages` for VGG-16."""
    head_stages(vgg["j"], vgg["model"], INFO)


def end_to_end(what, case, j=None, pm=None):
    """The port's detect from the canvases against JAX's stages ``j``
    (:func:`tests.bf16_limits.compare_detect`, the chains' limits from the
    float32 run ``case["f32"]``), and :func:`chains`' cls_score."""
    j, pm, pm32 = j or case["j"], pm or case["model"], case["f32"]
    x, inf = T(case["images"]), T(case["info"])
    with torch.no_grad():
        feat = pm.extractor(pm._prepare(x, inf))
        rpn = pm.rpn(feat)
        raw = pm.detect(x, inf)
        feat32 = pm32.extractor(pm32._prepare(x, inf))
        rpn32 = pm32.rpn(feat32)
        cs32, bp32 = pm32.roi_forward(feat32, T(j["rois"]))
        cs, _ = pm.roi_forward(feat, T(j["rois"]))

    def head_on(rois):
        with torch.no_grad():
            cs, bp = pm.roi_forward(feat, T(rois))
        return torch.softmax(cs, -1).numpy(), bp.numpy()

    def epilogue(rois, valid, prob, bbox_pred):
        raw = RawDetections(*(T(np.asarray(a)) for a in (rois, valid, prob, bbox_pred)))
        with torch.no_grad():
            return [t.numpy() for t in postprocess(raw, inf, pm.cfg)]

    got = dict(rpn=rpn, rois=raw.rois.numpy(), roi_valid=raw.roi_valid.numpy(),
               cls_prob=raw.cls_prob.numpy(), bbox_pred=raw.bbox_pred.numpy())
    ref = dict(rpn=j["rpn"], rois=j["rois"], roi_valid=j["roi_valid"], cls_score=j["cls_score"],
               cls_prob=j["raw"].cls_prob, bbox_pred=j["raw"].bbox_pred, dets=j["dets"])
    x32 = dict(logits=rpn32.logits, deltas=rpn32.deltas, fg_probs=rpn32.fg_probs,
               cls_score=cs32, cls_prob=torch.softmax(cs32, -1), bbox_pred=bp32)
    x32 = {k: _np(v) for k, v in x32.items()}
    res = compare_detect(what, pm.cfg, ref, got, x32, case["info"], head_on, epilogue)
    res["read"]["cls_score"] = chain(f"{what} cls_score", cs, j["cls_score"], x32["cls_score"])
    return res


def test_vgg16_end_to_end_matches_jax(vgg):
    """From the uint8 canvases (:func:`end_to_end`)."""
    print("VGG-16 bf16 end to end:", end_to_end("VGG-16", vgg))


# ------------------------------------------------------------ rounding order


def _integer_leaves(tree, rng):
    """Kernels in {-1, 0, 1}, biases multiples of 1/8 (a fraction, so that
    rounding the convolution and adding the bias in bf16 differs from one
    rounding of the sum), FrozenBN leaves whose fold rounds to a multiply
    by 1/2 and an add of a multiple of 1/4 in bf16."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "mean" in v:
                ch = v["mean"].shape[0]
                v.update(scale=np.full(ch, 0.5, np.float32), var=np.ones(ch, np.float32),
                         mean=np.zeros(ch, np.float32),
                         bias=(rng.integers(-8, 9, ch) / 4).astype(np.float32))
            else:
                _integer_leaves(v, rng)
        elif k == "kernel":
            tree[k] = rng.choice([-1.0, 0.0, 0.0, 1.0], v.shape).astype(np.float32)
        elif k == "bias":
            tree[k] = (rng.integers(-64, 65, v.shape) / 8).astype(np.float32)


def _exact_case(jmod, pmod, x, rng, nchw=False):
    """flax module ``jmod`` (bf16 compute) and the port's ``pmod`` on the
    integer input x (float32 numpy, NHWC) with integer-valued leaves:
    their outputs as float32 numpy pairs."""
    params = jax.tree.map(np.array, jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    _integer_leaves(params["params"], rng)
    # operation by operation: jitted, XLA on the CPU drops a bf16 rounding
    # that a float32 cast follows (its allow_excess_precision), e.g. the RPN
    # logits' and deltas' (387.125 where flax's order gives 388)
    want = jmod.apply(params, jnp.asarray(x))
    pmod.load_state_dict(flax_to_state_dict(params))
    xt = T(x)
    with torch.no_grad():
        got = pmod(xt.permute(0, 3, 1, 2).to(BF16)).permute(0, 2, 3, 1) if nchw else pmod(xt)
    pairs = zip(got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))
    return [(_np(g), np.asarray(jnp.asarray(w, jnp.float32))) for g, w in pairs]


def test_layers_round_as_flax():
    """Integer-valued inputs and leaves make every float32 sum exact in any
    order, so each layer of the shipped bf16 path is bit-equal to flax's
    only if it rounds where flax rounds: a VGG convolution (rounded, then
    the bias in bf16, then ReLU), the RPN head (bf16 convolutions, float32
    logits and deltas, float32 softmax), the VGG head (fc6 and fc7 in bf16
    with their biases, cls_score and bbox_pred in float32) and a
    projecting, striding bottleneck (bf16 convolutions, each FrozenBN's
    multiply and add rounded apart, the residual add in bf16).  The
    port's layers take float32 input and cast it, as the trunk hands the
    heads bf16; the RPN's softmax, float32 on both sides, within 1e-6."""
    rng = np.random.default_rng(21)
    ints = lambda *shape: rng.integers(-64, 65, shape).astype(np.float32)  # noqa: E731

    class Conv(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers_0 = torch.nn.Conv2d(8, 16, 3, padding=1)   # flax's Sequential name

        def forward(self, x):
            return vgg16.conv_nchw(x, self.layers_0)

    jconv = fnn.Sequential([fnn.Conv(16, (3, 3), padding="SAME", dtype=jnp.bfloat16,
                                     param_dtype=jnp.float32), fnn.relu])
    cases = {"conv": (jconv, Conv(), ints(2, 9, 11, 8), True)}
    cases["rpn"] = (jax_rpn.RPNHead(num_anchors=3, mid_channels=8, dtype=jnp.bfloat16),
                    rpn.RPNHead(16, 3, 8, BF16, "cpu"), ints(2, 5, 7, 16), False)
    cases["vgg head"] = (jax_roi_head.VGG16RoIHead(num_classes=5, hidden=16, dtype=jnp.bfloat16),
                         roi_head.VGG16RoIHead(2 * 2 * 8, 5, 16, BF16, "cpu"),
                         ints(6, 2, 2, 8), False)
    cases["bottleneck"] = (jax_resnet.Bottleneck(channels=4, stride=2, project=True,
                                                 dtype=jnp.bfloat16),
                           resnet.Bottleneck(8, 4, 2, True, "cpu"), 4 * ints(2, 9, 11, 8), True)
    for name, (jmod, pmod, x, nchw) in cases.items():
        pairs = _exact_case(jmod, pmod, x, rng, nchw)
        if name == "rpn":       # fg_probs: a float32 softmax on equal logits
            np.testing.assert_allclose(pairs[0][0], pairs[0][1], rtol=0, atol=1e-6)
            pairs = pairs[1:]
        for i, (got, want) in enumerate(pairs):
            assert got.shape == want.shape, (name, i)
            assert np.abs(want).max() > 256, (name, i)     # values bf16 must round
            np.testing.assert_array_equal(got, want, err_msg=f"{name} output {i}")


# ------------------------------------------------------------ ResNet-101-C4 detect

# bf16 rounding points on a bottleneck's longest path: conv1, bn1 (2),
# conv2, bn2 (2), conv3, bn3 (2), the residual add
R_BLOCK = 10
R101_STAGES = (("res2", 3), ("res3", 4), ("res4", 23))


@pytest.fixture(scope="module")
def r101(tmp_path_factory):
    """tests/test_cross_impl_resnet.py's weights and image (the run's shared
    copy), JAX's bf16 stages (one compile) and the port's bf16 and float32
    models."""
    cfg, _, params, images, im_info = r101_fixture(tmp_path_factory)
    params = jax.tree.map(np.array, params)
    info = np.asarray(im_info, np.float32)
    return dict(cfg=cfg, j=jax_stages(cfg, params, images, info), params=params,
                model=port_model(cfg, params), f32=port_model(cfg, params, torch.float32),
                images=np.asarray(images), info=info)


def r101_stages(case, pm, check=True):
    """Every ResNet-101-C4 stage from JAX's input to it (:func:`stage`):
    conv1 + FrozenBN (r=3), each of res2-res4's 30 bottlenecks (R_BLOCK),
    the RPN (r=4), each of res5's 3 bottlenecks on JAX's pooled crops, and
    the C5 mean with the float32 output layers (r=1)."""
    from trcnn_torch.models.resnet import conv, max_pool, spatial_mean

    j, e, t, out = case["j"], pm.extractor, case["j"]["trunk"], {}
    nchw = lambda a: _bf(a).permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    with torch.no_grad():
        x = T(j["prep"]).to(BF16).permute(0, 3, 1, 2)
        out["bn1"] = stage("conv1 + bn1", nhwc(e.bn1(conv(x, e.conv1))), t["bn1"], 3, check)
        x = max_pool(torch.relu(nchw(t["bn1"])))
        for name, n in R101_STAGES:
            for i in range(1, n + 1):
                key = f"{name}/block{i}"
                out[key] = stage(key, nhwc(getattr(getattr(e, name), f"block{i}")(x)), t[key],
                                 R_BLOCK, check)
                x = nchw(t[key])
        rpn = pm.rpn(_bf(j["feat"]))
        for k in ("logits", "deltas"):
            out[f"rpn {k}"] = stage(f"rpn {k}", getattr(rpn, k), getattr(j["rpn"], k), 4, check)
        b, n = j["rois"].shape[:2]
        x = nchw(j["pooled"].reshape((b * n,) + j["pooled"].shape[2:]))
        for i in range(1, 4):
            key = f"res5/block{i}"
            out[key] = stage(key, nhwc(getattr(pm.head.res5, f"block{i}")(x)),
                             j["res5"][f"block{i}"], R_BLOCK, check)
            x = nchw(j["res5"][f"block{i}"])
        y = spatial_mean(x).float()
        out["head cls_score"] = stage("mean + cls_score", roi_head.dense(y, pm.head.cls_score),
                                      j["cls_score"].reshape(b * n, -1), 1, check)
    return out


def test_resnet101_stages_match_jax(r101):
    """ResNet-101-C4 in bf16: ``_prepare`` bit-equal, every stage
    (:func:`r101_stages`), the chains (:func:`chains`) and
    :func:`head_stages`."""
    pm = r101["model"]
    with torch.no_grad():
        np.testing.assert_array_equal(pm._prepare(T(r101["images"]), T(r101["info"])).numpy(),
                                      r101["j"]["prep"])
    head_stages(r101["j"], pm, r101["info"])
    print("ResNet-101 bf16 stages (ulps, rms in rho):", r101_stages(r101, pm),
          "; chains (fractions of the limits):", chains(r101, pm))


def test_resnet101_end_to_end_matches_jax(r101):
    """:func:`end_to_end` for ResNet-101-C4, with the RoI max pool and with
    RoIAlign (JAX's trunk, RPN and proposals reused: :func:`jax_stages`'
    ``base``)."""
    print("ResNet-101 bf16 end to end:", end_to_end("ResNet-101", r101))
    cfg = r101["cfg"].replace(roi=dataclasses.replace(r101["cfg"].roi, mode="align"))
    case = dict(r101, cfg=cfg, f32=port_model(cfg, r101["params"], torch.float32))
    j = jax_stages(cfg, r101["params"], r101["images"], r101["info"], base=r101["j"])
    print("ResNet-101 RoIAlign bf16 end to end:",
          end_to_end("ResNet-101 RoIAlign", case, j, port_model(cfg, r101["params"])))


def test_limits_fail_rounding_faults(vgg, r101):
    """The limits' upper readings: the port with one bf16 rounding fewer at
    every layer (:func:`fused_rounding`) and with bf16 sums of 16 input
    channels (``Bf16Accumulation(16)``) fails every stage's rms limit it
    reaches (the C5 mean and conv1, with 3 input channels, have nothing of
    the second to reach, the float32 output layers nothing of either, and
    ResNet-101's RPN, whose biases are zero here, nothing of the first), and
    with bf16 sums of 2 channels every chain's rms limit.  Prints each
    reading."""
    report = {}
    # the RPN's biases are zero in ResNet-101's fixture: folding them rounds nothing
    unreached = {"VGG-16": (), "ResNet-101": ("rpn logits", "rpn deltas")}
    for name, case, stages in (("VGG-16", vgg, vgg_stages), ("ResNet-101", r101, r101_stages)):
        for fault, make, skip in (("one rounding fewer", fused_rounding,
                                   ("head cls_score",) + unreached[name]),
                                  ("bf16 sums of 16", lambda: Bf16Accumulation(16),
                                   ("head cls_score", "bn1"))):
            with make():
                got = stages(case, case["model"], check=False)
            passed = {k: v for k, v in got.items() if k not in skip and v[1] <= STAGE_RMS}
            assert not passed, f"{name}, {fault}: stages within their limits {passed}"
            report[name, fault] = min(v[1] for k, v in got.items() if k not in skip)
        with Bf16Accumulation(2):
            got = chains(case, case["model"], check=False)
        assert all(v[1] > 1.0 for v in got.values()), (name, got)
        report[name, "bf16 sums of 2, chains"] = got
    print("controls (smallest stage rms in rho; chains' fractions of their limits):", report)


# ------------------------------------------------------------ VGG-16 training step


U_BF16 = 2.0 ** -7      # a bf16 ulp relative to the value, at most


class _Terms(torch.overrides.TorchFunctionMode):
    """Records, for each convolution and matmul of a run, its input and the
    cotangent of its output, keyed by the parameter its weight was cast
    from: the terms a weight's and a bias's gradient sum."""

    def __init__(self):
        super().__init__()
        self.by_param = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (F.conv2d, F.linear) and out.requires_grad:
            w = args[1]
            if w.grad_fn is not None:            # a cast of the parameter
                w = getattr(w.grad_fn.next_functions[0][0], "variable", None)
            if w is not None:
                rec = dict(x=args[0].detach(), conv=func is F.conv2d,
                           stride=kwargs.get("stride", args[3] if len(args) > 3 else 1),
                           padding=kwargs.get("padding", args[4] if len(args) > 4 else 0))
                out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach()))
                self.by_param[id(w)] = rec
        return out


def _term_sums(rec, shape, bias):
    """The float64 sums of a weight's (``shape``) or, with ``bias``, the
    bias's gradient terms t (the products of the recorded input and
    cotangent), and sum |t|, as arrays of the gradient's shape."""
    x, g = rec["x"].double(), rec["g"].double()
    if rec["conv"]:
        dims = (0, 2, 3)
        wsum = lambda a, b: torch.nn.grad.conv2d_weight(  # noqa: E731
            a, shape, b, stride=rec["stride"], padding=rec["padding"])
    else:
        dims = (0,)
        wsum = lambda a, b: b.t() @ a  # noqa: E731
    if bias:
        out = g.sum(dims), g.abs().sum(dims)
    else:
        out = wsum(x, g), wsum(x.abs(), g.abs())
    return [t.numpy() for t in out]


def _own_limit(exact, ab, n_sum, unit):
    """The port's gradient's limit against ``exact``, the float64 sum of
    its own terms t (its bf16 inputs times its bf16 cotangents), element
    by element: it sums them in float32 (statistically lambda_n sqrt(n_sum)
    2^-24 sum |t|) and rounds the sum once to the gradient's dtype (half
    its ``unit``, an ulp relative to the value)."""
    return 0.5 * unit * np.abs(exact) + lam(exact.size) * math.sqrt(n_sum) * 2.0 ** -24 * ab


def _port_step(cfg, params, dtype, tb, uniforms, props, terms=None):
    """One training step of the port from JAX's float32 parameters, on
    JAX's proposals and sampling draws: metrics, gradients and parameters
    after the update (float64 numpy), the RPN's and the head's outputs
    (float32 numpy) and the parameters themselves."""
    from trcnn_torch.train import TrainState, train_step
    from trcnn_torch.train.step import BATCH_KEYS

    pm = make_model(cfg, dtype=dtype, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params))
    outs = {}
    hooks = [pm.rpn.register_forward_hook(lambda m, i, o: outs.update(rpn=o)),
             pm.head.register_forward_hook(lambda m, i, o: outs.update(head=o))]
    state = TrainState.create(pm)
    with terms or contextlib.nullcontext():
        metrics = train_step(state, {k: tb[k] for k in BATCH_KEYS}, uniforms=uniforms,
                             proposals=props)
    for h in hooks:
        h.remove()
    ps = dict(pm.named_parameters())
    return dict(params_p=ps, metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad.double().numpy() for k, p in ps.items() if p.grad is not None},
                params={k: p.detach().double().numpy() for k, p in ps.items()},
                out=dict(logits=_np(outs["rpn"].logits), deltas=_np(outs["rpn"].deltas),
                         cls_score=_np(outs["head"][0]), bbox_pred=_np(outs["head"][1])))


def train_parity(cfg, params, batch, uniforms_of):
    """One bf16 training step of the port and JAX's bf16 losses and
    gradients, from the same float32 parameters, sampling draws and
    proposals (JAX's; each flip of the port's own shown within its margin
    by :func:`proposal_flips`), and the port's float32 step on the same,
    the chains' upper reading.  Returns the measurements; asserts:

    * sampled counts equal; each loss within :func:`loss_limits` (the RPN's
      chains against JAX's logits and deltas, the head's against the
      port's own cls_score and bbox_pred: JAX's head outputs are inside
      its graph);
    * each trained tensor's gradient: the port's, element by element,
      within its float32 sum's and one rounding's limit of the float64 sum
      of its own terms (its bf16 inputs times its bf16 cotangents,
      recorded by :class:`_Terms`); and the gradients against JAX's within
      :func:`gradient_chains` from the float32 step's (JAX's gradient is
      the larger error here, its bf16 sums on the CPU, which the float32
      step's distance from it holds), after showing JAX's the larger error
      against those float64 sums (in most tensors, and summed over all).
      The float64 model is no oracle for the whole step: bf16 ties in the
      2x2 and RoI max pools route a gradient to another cell than float64
      values do, on both sides alike;
    * the update of one CaffeSGD step against optax's on JAX's gradients:
      within 1e-5 of the parameter's largest magnitude plus the learning
      rate (doubled for biases) times GRAD_CAP times the gradient's largest
      limit."""
    from trcnn.train.optim import make_optimizer
    from trcnn.train.step import TrainState as JaxTrainState
    from trcnn_torch.train import learning_rate
    from trcnn_torch.train.optim import is_frozen
    from trcnn_torch.train.step import BATCH_KEYS

    import optax

    jm = jax_make_model(cfg, dtype=jnp.bfloat16)
    jbatch = [jnp.asarray(batch[k]) for k in BATCH_KEYS]
    drop, samp = jax.random.split(jax.random.PRNGKey(11))

    def loss_fn(p):
        out = jm.apply(p, *jbatch, method="losses", rngs={"dropout": drop, "sampling": samp})
        return out["loss"], out

    @jax.jit
    def grads_and_proposals(p):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        feat = jm.apply(p, jbatch[0], method="features")
        rpn = jm.apply(p, feat, method="rpn_out")
        props = jax.vmap(lambda f, d, i: jax_proposal_layer(
            f, d, i[0], i[1], i[2], train=True, anchor_cfg=cfg.anchors,
            cfg=cfg.proposals))(rpn.fg_probs, rpn.deltas, jbatch[1])
        return metrics, grads, rpn, props

    jmetrics, jgrads, jrpn, jprops = jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a),
        grads_and_proposals(params))
    uniforms = {k: T(v) for k, v in uniforms_of(jm, params, samp).items()}
    tx = make_optimizer(params, cfg.optim, cfg.backbone)
    upd, _ = tx.update(jgrads, JaxTrainState.create(params, tx).opt_state, params)
    jnew = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(
        np.asarray, optax.apply_updates(params, upd))).items()}
    jgrads = {k: v.numpy() for k, v in flax_to_state_dict(jgrads).items()}

    tb = {k: T(np.array(v)) for k, v in batch.items()}
    props = (T(jprops.rois), T(jprops.valid))
    terms = _Terms()
    got = _port_step(cfg, params, BF16, tb, uniforms, props, terms)
    x32 = _port_step(cfg, params, torch.float32, tb, uniforms, props)
    pm = make_model(cfg, dtype=BF16, device="cpu")       # the port's own proposals
    pm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        rpn_own = pm.rpn(pm.extractor(tb["images"]))
        own = pm.propose(rpn_own, tb["im_info"], train=True)
    train_cfg = cfg.replace(proposals=dataclasses.replace(
        cfg.proposals, pre_nms_topk_test=cfg.proposals.pre_nms_topk_train,
        post_nms_topk_test=cfg.proposals.post_nms_topk_train))
    flips, _ = proposal_flips(train_cfg, jrpn, rpn_own, jprops,
                              Props(own[0].numpy(), own[1].numpy()), batch["im_info"])

    m = got["metrics"]
    assert m["num_fg_anchors"] == jmetrics["num_fg_anchors"] > 0
    assert m["num_fg_rois"] == jmetrics["num_fg_rois"] > 0
    ref = dict(got["out"], logits=jrpn.logits, deltas=jrpn.deltas)
    loss_lim = loss_limits(ref, x32["out"])
    for k, lim in loss_lim.items():
        assert abs(m[k] - jmetrics[k]) <= lim, (k, m[k], jmetrics[k], lim)

    report, own_err = {}, {}
    lr = learning_rate(cfg.optim, 0)
    params_p = got["params_p"]
    for name, g in got["grads"].items():
        layer, leaf = name.rsplit(".", 1)
        if is_frozen(name, cfg.backbone):     # ResNet-101's FrozenBN leaves: never applied
            continue
        w = params_p[layer + ".weight"]
        rec = terms.by_param[id(w)]
        exact, ab = _term_sums(rec, w.shape, leaf == "bias")
        assert np.abs(exact).max() > 0, name
        n_sum = rec["g"].numel() // rec["g"].shape[1 if rec["conv"] else -1]
        unit = 2.0 ** -24 if rec["g"].dtype == torch.float32 else U_BF16
        lim_p = _own_limit(exact, ab, n_sum, unit)
        e_p = np.abs(g - exact)
        own_err[name] = (float(e_p.max()), float(np.abs(jgrads[name] - exact).max()))
        own_ratio = np.divide(e_p, lim_p, out=np.where(e_p > 0, np.inf, 0.0), where=lim_p > 0)
        assert (e_p <= lim_p).all(), (f"{name}: the port's bf16 gradient against the float64 "
                                      f"sum of its terms: {own_ratio.max():.3f} of its limit")
        report[name] = dict(own=round(float(own_ratio.max()), 3),
                            jax_ulps=round(ulps(g, jgrads[name]), 2))
        step_lr = lr * (2.0 if leaf == "bias" else 1.0)
        new = got["params"][name]
        slack = (1e-5 * float(np.abs(new).max())
                 + step_lr * GRAD_CAP * chain_limits(jgrads[name], x32["grads"][name])[0])
        assert (np.abs(new - jnew[name]) <= slack).all(), name
    chains_, pooled = gradient_chains("port against JAX", {k: got["grads"][k] for k in report},
                                      jgrads, x32["grads"])
    for name, r in chains_.items():
        report[name]["chain"] = r
    # JAX's bf16 sums are the larger error: against the float64 sums of the
    # port's terms, JAX's gradients are further off than the port's in most
    # tensors and by more in all of them together
    worse = sum(j > p_ for p_, j in own_err.values())
    assert worse > len(own_err) / 2, own_err
    assert sum(j for _, j in own_err.values()) > sum(p_ for p_, _ in own_err.values()), own_err
    for name in jgrads:
        if name not in got["grads"]:
            assert is_frozen(name, cfg.backbone) and not jgrads[name].any(), name
    return dict(flips=flips, grads=report, pooled=pooled,
                losses={k: (m[k], jmetrics[k], loss_lim[k]) for k in loss_lim})


def test_vgg16_bf16_training_step_matches_jax(tmp_path_factory):
    """tests/test_cross_impl_train.py's fixture and draws, bf16 compute
    (:func:`train_parity`)."""
    from tests.test_cross_impl_train import B, _derive_uniforms, _geom, _sampling_rng
    from trcnn_torch.models.faster_rcnn import UNIFORM_KEYS

    cfg, _, params, images, im_info, (gtb, gtl, gtv) = vgg_train_fixture(tmp_path_factory)
    fh, fw, n, n_cand = _geom(cfg)

    def uniforms_of(jm, p, samp):
        _, _, uni = _derive_uniforms(_sampling_rng(jm, p, samp), B, n, n_cand)
        return {k: np.stack([u[k] for u in uni]) for k in UNIFORM_KEYS}

    batch = {"images": images, "im_info": im_info, "gt_boxes": gtb, "gt_labels": gtl,
             "gt_valid": gtv}
    got = train_parity(cfg, params, batch, uniforms_of)
    top = sorted(got["grads"], key=lambda k: got["grads"][k]["chain"][1])[-3:]
    print("VGG-16 bf16 training step:", len(got["flips"]), "proposal flips within their margins;",
          "losses (port, JAX, limit):", got["losses"], "; gradients, pooled rms fraction",
          got["pooled"], ", highest:", {k: got["grads"][k] for k in top},
          ", own float32 sums' largest fraction:", max(g["own"] for g in got["grads"].values()))


def test_vgg16_align_end_to_end_matches_jax(vgg):
    """RoIAlign (``mode="align"``) in bf16 on the VGG-16 fixture, end to end
    (:func:`end_to_end`; JAX's trunk, RPN and proposals reused: the port's
    RoIAlign rounds its float32 means to bf16 once, as JAX's head casts
    JAX's float32 crops); and its crops from JAX's features and RoIs within
    one bf16 ulp of JAX's, cast (tests/test_torch_roi_align.py measured 7-8
    elements of 21560 rounding the other way)."""
    from trcnn_torch.ops.roi_align import roi_align

    cfg = vgg["cfg"].replace(roi=dataclasses.replace(vgg["cfg"].roi, mode="align"))
    j = jax_stages(cfg, vgg["params"], vgg["images"], INFO, base=vgg["j"])
    with torch.no_grad():
        crops = roi_align(_bf(j["feat"]), T(j["rois"]), cfg.roi.output_size,
                          cfg.roi.spatial_scale, out_dtype=BF16)
    want = np.asarray(jnp.asarray(j["pooled"], jnp.bfloat16).astype(jnp.float32))
    assert float(np.abs(_np(crops) - want).max()) <= bf16_ulp(np.abs(want)).max()
    case = dict(vgg, cfg=cfg, f32=port_model(cfg, vgg["params"], torch.float32))
    got = end_to_end("VGG-16 RoIAlign", case, j, port_model(cfg, vgg["params"]))
    print("VGG-16 RoIAlign bf16 end to end:", got)
