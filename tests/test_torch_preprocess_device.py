"""The port's ``preprocess_device`` on the CPU: against the JAX package's
``preprocess_device`` on the same raw buffers (im_info equal, the canvas
within 1e-4: the same float32 weights, contracted in another order), a
scale whose ``raw_h * s`` lands on .5 among them (rounded half to even, as
``jnp.round``); and the twins of tests/test_preprocess_device.py against
the port's host path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trcnn.config import ImageConfig as JaxImageConfig
from trcnn.data.preprocess import preprocess_device as jax_preprocess_device
from trcnn_torch.config import ImageConfig
from trcnn_torch.data.preprocess import preprocess_device, preprocess_image
from trcnn_torch.entry import tiny_config
from trcnn_torch.models import make_model
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

CANVAS_ATOL = 1e-4

# (raw buffer, image extent, scale, canvas config)
CASES = {
    "interior": ((64, 96), (45, 80), 60.0 / 45.0,
                 dict(target_min_size=60, target_max_size=100, pad_h=64, pad_w=112)),
    # 38 * 1.75 = 66.5 -> 66 (half to even; half away from zero gives 67)
    "half": ((64, 96), (38, 80), 1.75,
             dict(target_min_size=60, target_max_size=160, pad_h=80, pad_w=144)),
    # a downscale of a buffer larger than the image, garbage beyond it
    "down": ((40, 70), (33, 61), 0.7, dict(target_min_size=20, target_max_size=64,
                                           pad_h=32, pad_w=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_jax_preprocess_device(case):
    (bh, bw), (h, w), scale, kw = CASES[case]
    raw = np.random.RandomState(len(case)).randint(0, 256, size=(bh, bw, 3)).astype(np.uint8)
    want_canvas, want_info = jax.jit(
        lambda r, hh, ww, s: jax_preprocess_device(r, hh, ww, s, JaxImageConfig(**kw)))(
        jnp.asarray(raw), h, w, scale)
    canvas, info = preprocess_device(torch.from_numpy(raw), h, w, scale, ImageConfig(**kw))
    np.testing.assert_array_equal(info.numpy(), np.asarray(want_info))
    assert canvas.dtype == torch.float32 and canvas.shape == (kw["pad_h"], kw["pad_w"], 3)
    np.testing.assert_allclose(canvas.numpy(), np.asarray(want_canvas), rtol=0, atol=CANVAS_ATOL)
    if case == "half":
        assert info[0] == 66.0
    # the same from tensors for the extent and the scale
    again, info2 = preprocess_device(torch.from_numpy(raw), torch.tensor(h), torch.tensor(w),
                                     torch.tensor(scale), ImageConfig(**kw))
    assert torch.equal(again, canvas) and torch.equal(info2, info)


def test_device_preprocess_matches_host_interior():
    """The twin of tests/test_preprocess_device.py's: the interior within
    1.5 of the host path (cv2's generic bilinear there), im_info alike,
    the padding exactly zero; the canvas passes ``FasterRCNN._prepare``
    unchanged (float input)."""
    cfg = ImageConfig(target_min_size=60, target_max_size=100, pad_h=64, pad_w=112)
    img = np.random.RandomState(0).randint(0, 256, size=(45, 80, 3)).astype(np.uint8)
    host_canvas, host_info = preprocess_image(img, cfg)
    raw = np.zeros((64, 96, 3), np.uint8)
    raw[:45, :80] = img
    canvas, info = preprocess_device(torch.from_numpy(raw), 45, 80, float(host_info[2]), cfg)
    canvas = canvas.numpy()
    np.testing.assert_allclose(info.numpy(), host_info, rtol=1e-5)
    sh, sw = int(host_info[0]), int(host_info[1])
    np.testing.assert_allclose(host_canvas[:sh - 2, :sw - 2], canvas[:sh - 2, :sw - 2], atol=1.5)
    assert (canvas[sh:] == 0).all() and (canvas[:, sw:] == 0).all()
    model = make_model(tiny_config(), device="cpu")
    x = torch.from_numpy(canvas)[None]
    assert model._prepare(x, info[None]) is x


def test_device_preprocess_masks_raw_padding():
    """The twin of tests/test_preprocess_device.py's: garbage beyond the raw
    extent does not leak into the canvas."""
    cfg = ImageConfig(target_min_size=32, target_max_size=64, pad_h=32, pad_w=64)
    raw = np.full((40, 70, 3), 255, np.uint8)
    raw[:20, :40] = 10
    canvas, info = preprocess_device(torch.from_numpy(raw), 20, 40, 32.0 / 20.0, cfg)
    sh, sw = int(info[0]), int(info[1])
    means = np.asarray(cfg.pixel_means_bgr, np.float32)
    interior = canvas.numpy()[:sh - 2, :sw - 2] + means
    assert abs(interior.mean() - 10.0) < 1.0
