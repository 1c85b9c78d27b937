"""The port's dynamic int8 mode (``make_model(..., quant="int8")``) against
the JAX package's (``trcnn/ops/quant.py``), on the CPU.

Bit-equal: the per-tensor and per-channel quantizers (codes and scales;
the scale is a float32 quotient, the rounding half to even) and
``qconv2d``/``qdense`` on the same inputs (the int8 products are exact in
int32; the dequantization is the same float32 operations in the same
order).  The tiny VGG-16 int8 model (tests/test_torch_slice.py's config,
float32 compute) against JAX's int8 model on the same weights, with the
count of codes that differ at each of the 13 quantized inputs in the
assertion message: with a stem whose float32 sums are exact, no code
differs and the detections are equal; with the seeded stem, the last-bit
differences of the float32 stems move a few codes, and every quantized
layer multiplies them (the tolerances are in that test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trcnn.ops.quant as jax_quant
from trcnn.config import FasterRCNNConfig, ProposalConfig
from trcnn.models import make_model as jax_make_model
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.entry import entry
from trcnn_torch.models import cast_params_for_inference, make_model, postprocess
from trcnn_torch.ops import quant
from tests.test_torch_package import _tiny_cfg
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy


def _conv(kernel_hwio, bias):
    kh, kw, cin, cout = kernel_hwio.shape
    conv = torch.nn.Conv2d(cin, cout, (kh, kw), padding=(kh // 2, kw // 2))
    with torch.no_grad():
        conv.weight.copy_(T(kernel_hwio).permute(3, 2, 0, 1))
        conv.bias.copy_(T(bias))
    return conv


def _linear(kernel_df, bias):
    lin = torch.nn.Linear(*kernel_df.shape)
    with torch.no_grad():
        lin.weight.copy_(T(kernel_df.T.copy()))
        lin.bias.copy_(T(bias))
    return lin


def test_quantize_tensor_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    # amax 127 makes the scale 1.0: the .5 values test round half to even
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    for x in (ties, (rng.standard_normal((3, 7, 5)) * 13).astype(np.float32),
              np.zeros((4, 3), np.float32), np.full(5, 1e-14, np.float32)):
        q, s = jax_quant.quantize_tensor(jnp.asarray(x))
        tq, ts = quant.quantize_tensor(T(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert ts.item() == float(s)
    assert quant.quantize_tensor(T(ties))[0].tolist() == [127, 0, 2, 2, 0, -2, 126]
    # bf16 input: the same codes as JAX's from bf16
    xb = (rng.standard_normal((4, 9)) * 3).astype(np.float32)
    q, s = jax_quant.quantize_tensor(jnp.asarray(xb).astype(jnp.bfloat16))
    tq, ts = quant.quantize_tensor(T(xb).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert ts.item() == float(s)


def test_quantize_channels_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((3, 3, 13, 24)) * 0.1).astype(np.float32)
    k[..., 5] = 0.0                                   # an all-zero channel: the 1e-12 floor
    q, s = jax_quant.quantize_channels(jnp.asarray(k), axis=3)
    tq, ts = quant.quantize_channels(T(k).permute(3, 2, 0, 1), axis=0)   # OIHW
    np.testing.assert_array_equal(tq.permute(2, 3, 1, 0).numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    d = (rng.standard_normal((37, 21)) * 0.1).astype(np.float32)          # (D, F)
    q, s = jax_quant.quantize_channels(jnp.asarray(d), axis=1)
    tq, ts = quant.quantize_channels(T(d.T.copy()), axis=0)               # (F, D)
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qconv2d_and_qdense_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    x = (rng.standard_normal((2, 6, 7, 13)) * 3).astype(np.float32)
    k = (rng.standard_normal((3, 3, 13, 24)) * 0.2).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jax_quant.qconv2d(jnp.asarray(x).astype(jdt), jnp.asarray(k),
                                        jnp.asarray(b)))
    got = quant.qconv2d(T(x).to(tdt), _conv(k, b)).detach()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    xd = rng.standard_normal((5, 37)).astype(np.float32)
    kd = rng.standard_normal((37, 21)).astype(np.float32)
    bd = rng.standard_normal(21).astype(np.float32)
    want = np.asarray(jax_quant.qdense(jnp.asarray(xd).astype(jdt), jnp.asarray(kd),
                                       jnp.asarray(bd)))
    np.testing.assert_array_equal(quant.qdense(T(xd).to(tdt), _linear(kd, bd)).detach().numpy(),
                                  want)


def test_activation_scale_spans_the_batch():
    """One image alone and the same image beside a brighter one quantize
    differently, in JAX and in the port alike."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 6, 8)).astype(np.float32)
    pair = np.concatenate([x, 4 * x])
    k = (rng.standard_normal((3, 3, 8, 16)) * 0.2).astype(np.float32)
    b = np.zeros(16, np.float32)
    conv = _conv(k, b)
    alone = quant.qconv2d(T(x), conv).detach().numpy()
    beside = quant.qconv2d(T(pair), conv).detach().numpy()[:1]
    assert not np.array_equal(alone, beside)
    np.testing.assert_array_equal(
        beside, np.asarray(jax_quant.qconv2d(jnp.asarray(pair), jnp.asarray(k), jnp.asarray(b)))[:1])


def test_weight_codes_are_cached_and_follow_the_weights():
    rng = np.random.default_rng(4)
    conv = _conv((rng.standard_normal((3, 3, 8, 16)) * 0.2).astype(np.float32),
                 np.zeros(16, np.float32))
    q1, s1 = quant.weight_codes(conv)
    assert quant.weight_codes(conv)[0] is q1                  # cached
    fresh = quant.quantize_channels(conv.weight, 0)[0].permute(0, 2, 3, 1).reshape(16, -1)
    assert torch.equal(q1, fresh)
    with torch.no_grad():
        conv.weight.mul_(-1.0)                                # in place: recomputed
    assert torch.equal(quant.weight_codes(conv)[0], -q1)
    conv.weight.data = conv.weight.data.to(torch.bfloat16)    # a new tensor: recomputed
    q3, s3 = quant.weight_codes(conv)
    assert q3 is not q1 and torch.equal(
        q3, quant.quantize_channels(conv.weight, 0)[0].permute(0, 2, 3, 1).reshape(16, -1))


def _cfg():
    """tests/test_torch_slice.py's config."""
    return FasterRCNNConfig(
        head_hidden=32, rpn_channels=16,
        proposals=ProposalConfig(pre_nms_topk_test=192, post_nms_topk_test=24,
                                 pre_nms_topk_train=192, post_nms_topk_train=48))


def _record(calls, jax_side=False):
    """Wrap a quantize_tensor so that each call's codes land in ``calls``
    (through an ordered debug callback inside JAX's jitted graph)."""
    def wrap(fn):
        def recorded(x):
            q, s = fn(x)
            if jax_side:
                jax.debug.callback(lambda a: calls.append(np.asarray(a)), q, ordered=True)
            else:
                calls.append(q.numpy())
            return q, s
        return recorded
    return wrap


@pytest.fixture(scope="module")
def int8_jax():
    """JAX's int8 model at the small config: its parameters, and its detect
    with every quantized input's codes recorded, run operation by operation
    (``op_by_op``: the float32 dequantization rounds as the port's does) or
    jitted (XLA contracts ``y * scale + bias`` into an FMA, which moves an
    occasional code by one step)."""
    cfg = _cfg()
    jmodel = jax_make_model(cfg, quant="int8")
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    images = np.asarray(jax.random.uniform(k1, (2, 64, 96, 3)) * 120.0 - 60.0)
    im_info = np.asarray([[60.0, 90.0, 1.2], [64.0, 80.0, 1.0]], np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(k2, images, im_info))
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_quant, "quantize_tensor", _record(calls, True)(jax_quant.quantize_tensor))
    detect = jax.jit(lambda p, x, info: jmodel.apply(p, x, info, method="detect"))
    post = jax.jit(lambda raw, info: jax_postprocess(raw, info, cfg, score_thresh=0.02))

    def run(p, x, op_by_op):
        del calls[:]
        if op_by_op:
            with jax.disable_jit():
                raw = jmodel.apply(p, x, im_info, method="detect")
        else:
            raw = detect(p, x, im_info)
        jax.effects_barrier()
        return jax.tree.map(np.asarray, (raw, post(raw, im_info))), list(calls)

    yield cfg, params, images, im_info, run
    mp.undo()


@pytest.mark.parametrize("stem", ["exact", "seeded"])
def test_vgg16_int8_detections_match_jax(int8_jax, monkeypatch, stem):
    """"exact": integer-valued images and conv1_1 / conv1_2 kernels, whose
    float32 sums are exact in any order, so both stems agree bit for bit,
    against JAX run operation by operation: no code apart at any quantized
    input, raw outputs within 1e-5 and the detections equal.  "seeded":
    the initialised weights on real-valued images, against JAX's jitted
    detect; the stems differ in the last bits (and XLA's FMA moves a
    dequantized value now and then), a few conv2_1 input codes land one
    step apart, and each quantized layer multiplies the count (measured:
    2 at conv2_1, 5,064 of 24,576 at conv5_3's input): the proposals stay
    equal and within 0.1 pixel, cls_prob within 1e-2 and bbox_pred within
    5e-2 of their largest magnitude (measured 1.5e-3 and 2.1e-2); the
    near-uniform class probabilities of the seeded head then reorder, so
    the detections are compared only in the exact case."""
    cfg, params, images, im_info, run = int8_jax
    params = jax.tree.map(lambda a: a.copy(), params)
    if stem == "exact":
        rng = np.random.default_rng(0)
        ext = params["params"]["extractor"]
        ext["conv1_1"]["kernel"] = rng.integers(-2, 3, (3, 3, 3, 64)).astype(np.float32)
        ext["conv1_2"]["kernel"] = (rng.integers(-2, 3, (3, 3, 64, 64)) / 16).astype(np.float32)
        images = np.round(images / 8)
    (jraw, jdets), jcodes = run(params, images, op_by_op=stem == "exact")

    model = make_model(cfg, device="cpu", quant="int8").eval()
    sd = flax_to_state_dict(params)
    assert sd.keys() == make_model(cfg, device="cpu").state_dict().keys()
    model.load_state_dict(sd)
    codes = []
    monkeypatch.setattr(quant, "quantize_tensor", _record(codes)(quant.quantize_tensor))
    x, info = T(np.array(images)), T(im_info)
    with torch.no_grad():
        raw = model.detect(x, info)
        dets = postprocess(raw, info, cfg, score_thresh=0.02)
    assert len(codes) == len(jcodes) == 13          # conv2_1 ... conv5_3, fc6, fc7
    apart = [int((a.astype(np.int32) != b.astype(np.int32)).sum()) for a, b in zip(codes, jcodes)]
    msg = (f"{stem}: int8 codes differing at each quantized input: {apart} of "
           f"{[a.size for a in jcodes]}")
    np.testing.assert_array_equal(raw.roi_valid.numpy(), jraw.roi_valid, err_msg=msg)
    if stem == "seeded":
        np.testing.assert_allclose(raw.rois.numpy(), jraw.rois, rtol=0, atol=0.1, err_msg=msg)
        for got, want, tol in ((raw.cls_prob, jraw.cls_prob, 1e-2),
                               (raw.bbox_pred, jraw.bbox_pred, 5e-2)):
            assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max(), msg
        return
    assert not any(apart), msg
    np.testing.assert_allclose(raw.rois.numpy(), jraw.rois, rtol=1e-6, atol=1e-4, err_msg=msg)
    for got, want in ((raw.cls_prob, jraw.cls_prob), (raw.bbox_pred, jraw.bbox_pred)):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), msg
    np.testing.assert_array_equal(dets.valid.numpy(), jdets.valid, err_msg=msg)
    assert jdets.valid.sum() > 0
    np.testing.assert_array_equal(dets.classes.numpy(), jdets.classes, err_msg=msg)
    np.testing.assert_allclose(dets.scores.numpy(), jdets.scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dets.boxes.numpy(), jdets.boxes, rtol=1e-5, atol=1e-3)


def test_int8_model_keeps_the_float_parameters():
    cfg = _cfg()
    f32 = make_model(cfg, device="cpu").state_dict()
    q = make_model(cfg, device="cpu", quant="int8")
    sd = q.state_dict()
    assert list(sd) == list(f32)
    assert all(sd[k].shape == f32[k].shape and sd[k].dtype == torch.float32 for k in sd)
    # a cast for serving keeps the int8 model's tree too
    assert list(cast_params_for_inference(q, torch.bfloat16).state_dict()) == list(f32)


def test_int8_refusals_follow_jax():
    cfg = _cfg()
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 64, 96, 3))
    info = jnp.asarray([[60.0, 90.0, 1.0]])
    for bad_cfg, mode, match in ((cfg.replace(backbone="resnet101"), "int8", "vgg16 backbone only"),
                                 (cfg, "int4", "unknown quant mode")):
        with pytest.raises(ValueError, match=match):
            jax_make_model(bad_cfg, quant=mode).init(key, x, info)
        with pytest.raises(ValueError, match=match):
            make_model(bad_cfg, device="cpu", quant=mode)
    model = make_model(cfg, device="cpu", quant="int8")
    gt = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="inference-only"):
        model.losses(torch.zeros((1, 64, 96, 3)), torch.tensor([[60.0, 90.0, 1.0]]), gt,
                     torch.ones((1, 1), dtype=torch.int32), torch.ones((1, 1), dtype=torch.bool),
                     generator=torch.Generator())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_int8_small_config_on_cpu(dtype):
    """entry(quant="int8") leaves the weights float32, as bench.py does for
    int8, and detects."""
    fn, (model, image, info) = entry("cpu", cfg=_tiny_cfg(), dtype=dtype, quant="int8")
    assert model.quant == "int8"
    assert model.extractor.conv3_1.weight.dtype == torch.float32
    dets = fn(model, torch.cat([image, image.flip(2)]), torch.cat([info, info]))
    assert torch.isfinite(dets.boxes).all() and dets.valid.any()
    # the weights' codes were made once, at the first call
    q = model.head.fc6._int8_codes[1]
    fn(model, image, info)
    assert model.head.fc6._int8_codes[1] is q
