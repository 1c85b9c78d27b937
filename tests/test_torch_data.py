"""The port's host data layer against the JAX package's, on the CPU (numpy
and cv2 on the JAX side; no JAX graph is compiled).

The resize.  The port's ``resize_bilinear`` is written to OpenCV's generic
C++ ``INTER_LINEAR`` path (``trcnn_torch/data/preprocess.py``) and must be
bit-equal to ``cv2.resize`` run with ``cv2.setUseOptimized(False)`` on
every case of the grid below.  The JAX package's loader calls ``cv2.resize``
with cv2's default dispatch, which in cv2 5.0.0 rounds otherwise at
most scales: the largest difference measured over the grid is
0.0068 in pixel units (0-255), 448 float32 ulps at 255; at VOC's most
common scale, 375x500 -> 600x800, the two agree bit for bit.  The test
holds the default dispatch to DISPATCH_ATOL.

Everything else is compared bit for bit with the JAX package's functions
while cv2 runs its generic path (a fixture sets it and restores the
setting after): ``preprocess_image`` (float32 and uint8),
``compute_scale``, ``canvas_shape``, ``scale_gt_boxes``, the VOC parser
and dataset on the fabricated tree of tests/test_arrival_rehearsal.py,
``SyntheticDetection``, and the batches of ``DetectionLoader``
(shuffle, repeat, flip augmentation, multi-scale, two shards, a union, a
partial final batch, uint8 and float32 canvases).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tests.test_arrival_rehearsal import _write_voc_tree  # noqa: E402
from trcnn import data as jax_data  # noqa: E402
from trcnn.config import ImageConfig as JaxImageConfig  # noqa: E402
from trcnn.data import preprocess as jax_pre  # noqa: E402
from trcnn_torch import data as torch_data  # noqa: E402
from trcnn_torch.config import ImageConfig  # noqa: E402
from trcnn_torch.data import (DetectionLoader, SyntheticDetection, VOCDetection,  # noqa: E402
                              canvas_shape, compute_scale, parse_voc_xml,
                              preprocess_image, resize_bilinear, scale_gt_boxes)
from trcnn_torch.data.image import read_image  # noqa: E402
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

# the largest |port - cv2 default dispatch| allowed, in pixel units
DISPATCH_ATOL = 0.0075

# (source h, w) -> (target h, w): VOC's 375x500 and 333x500 landscape and
# 500x375 portrait at the 600/1000 rule, odd ratios up and down, a
# multi-scale target (min size 480), a one-pixel axis, the identity
GRID = [((375, 500), (600, 800)), ((333, 500), (600, 901)), ((500, 375), (800, 600)),
        ((480, 640), (600, 800)), ((37, 51), (100, 77)), ((101, 99), (50, 49)),
        ((375, 500), (480, 640)), ((7, 1), (3, 5)), ((600, 1000), (600, 1000))]


@pytest.fixture
def generic_cv2(monkeypatch):
    """cv2 on its generic C++ path for the test, the setting restored after.
    Part of the setting (IPP) is per thread, so ``cv2.resize`` also sets it
    in the thread that calls it: the loaders resize on worker threads."""
    before = cv2.useOptimized()
    resize = cv2.resize

    def generic_resize(*args, **kwargs):
        cv2.setUseOptimized(False)
        return resize(*args, **kwargs)

    monkeypatch.setattr(cv2, "resize", generic_resize)
    cv2.setUseOptimized(False)
    yield
    cv2.setUseOptimized(before)


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("flip", [False, True], ids=["", "flip"])
@pytest.mark.parametrize("src,dst", GRID, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in GRID])
def test_resize_is_bit_equal_to_cv2_generic(src, dst, flip, generic_cv2):
    img = _image(*src).astype(np.float32)
    if flip:
        img = img[:, ::-1]
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(dst + (3,))
    assert _equal(resize_bilinear(img, dst[1], dst[0]), want)


def test_resize_against_cv2_default_dispatch():
    worst, worst_ulp = 0.0, 0.0
    for (h, w), (th, tw) in GRID:
        img = _image(h, w, 1).astype(np.float32)
        got = resize_bilinear(img, tw, th)
        want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR).reshape(got.shape)
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        worst_ulp = max(worst_ulp, err / float(np.spacing(np.float32(255))))
        if (h, w, th, tw) == (375, 500, 600, 800):
            assert _equal(got, want)
    print(f"largest difference from cv2's default dispatch: {worst:.4g} "
          f"({worst_ulp:.0f} float32 ulps at 255)")
    assert worst <= DISPATCH_ATOL


@pytest.mark.parametrize("as_uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("shape,flip,min_size", [((375, 500), False, None),
                                                 ((500, 333), True, None),
                                                 ((333, 500), True, 480)])
def test_preprocess_image_matches_the_jax_package(shape, flip, min_size, as_uint8, generic_cv2):
    img = _image(*shape, 2)
    got = preprocess_image(img, ImageConfig(), flip, min_size=min_size, as_uint8=as_uint8)
    want = jax_pre.preprocess_image(img, JaxImageConfig(), flip, min_size=min_size,
                                    as_uint8=as_uint8)
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert got[0].shape[:2] == canvas_shape(*shape)


def test_scale_rules_match_the_jax_package():
    cfg, jcfg = ImageConfig(), JaxImageConfig()
    boxes = np.asarray([[10, 20, 200, 300], [0, 0, 499, 374]], np.float32)
    for h, w in ((375, 500), (500, 375), (333, 500), (100, 1000), (600, 600), (17, 4000)):
        for min_size in (None, 480, 800):
            s = compute_scale(h, w, cfg, min_size)
            assert s == jax_pre.compute_scale(h, w, jcfg, min_size)
            for flip in (False, True):
                assert _equal(scale_gt_boxes(boxes, s, w, flip),
                              jax_pre.scale_gt_boxes(boxes, s, w, flip))
        assert canvas_shape(h, w, cfg) == jax_pre.canvas_shape(h, w, jcfg)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root, _ = _write_voc_tree(str(tmp_path_factory.mktemp("voc") / "VOC2007"),
                              np.random.RandomState(0))
    return root


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_dataset_matches_the_jax_package(voc_root, use_difficult):
    ours = VOCDetection(voc_root, "test", use_difficult)
    theirs = jax_data.VOCDetection(voc_root, "test", use_difficult)
    assert ours.ids == theirs.ids == ["000001", "000002"]
    for i in range(len(ours)):
        a, b = ours.get_example(i), theirs.get_example(i)
        assert a.keys() == b.keys()
        for k in ("image", "boxes", "labels", "difficult"):
            assert _equal(a[k], b[k]), k
        assert a["id"] == b["id"]
        assert ours.get_size(i) == theirs.get_size(i) == a["image"].shape[:2]
        ann = ours.get_annotation(i)
        assert all(_equal(ann[k], a[k]) for k in ("boxes", "labels", "difficult"))
    path = f"{voc_root}/Annotations/000002.xml"
    got, want = parse_voc_xml(path, use_difficult), jax_data.parse_voc_xml(path, use_difficult)
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert len(got[0]) == (2 if use_difficult else 1)        # the difficult cat
    assert _equal(read_image(f"{voc_root}/JPEGImages/000001.jpg"),
                  cv2.imread(f"{voc_root}/JPEGImages/000001.jpg", cv2.IMREAD_COLOR))


def test_synthetic_dataset_matches_the_jax_package():
    ours, theirs = SyntheticDetection(n=6, seed=3), jax_data.SyntheticDetection(n=6, seed=3)
    assert len(ours) == len(theirs) and ours.ids == theirs.ids
    for i in range(6):
        a, b = ours.get_example(i), theirs.get_example(i)
        assert a.keys() == b.keys() and a["id"] == b["id"]
        assert all(_equal(a[k], b[k]) for k in ("image", "boxes", "labels"))
        assert ours.get_size(i) == theirs.get_size(i) == a["image"].shape[:2]


# small canvases keep the loader cases cheap; sizes of both orientations
SMALL = dict(target_min_size=64, target_max_size=112, pad_h=80, pad_w=112)
HW = ((50, 90), (50, 90))
PORTRAIT_HW = ((70, 110), (40, 60))


def _datasets(kind, voc_root):
    if kind == "voc":
        return VOCDetection(voc_root, "test"), jax_data.VOCDetection(voc_root, "test")
    if kind == "concat":
        mk = lambda mod: mod.ConcatDetection([  # noqa: E731
            mod.SyntheticDetection(n=5, hw_range=HW, seed=1),
            mod.SyntheticDetection(n=4, hw_range=PORTRAIT_HW, seed=2)])
        return mk(torch_data), mk(jax_data)
    mk = lambda cls: cls(n=11, hw_range=((40, 100), (40, 100)), seed=4)  # noqa: E731
    return mk(SyntheticDetection), mk(jax_data.SyntheticDetection)


LOADER_CASES = {
    # kind, loader kwargs, image config, batches to compare
    "voc_f32": ("voc", dict(batch_size=2), {}, None),
    "voc_uint8_flip": ("voc", dict(batch_size=2, augment=True, seed=3, uint8_images=True), {},
                       None),
    "partial_flush": ("synthetic", dict(batch_size=4, max_boxes=3), SMALL, None),
    "shuffle_repeat_augment": ("synthetic", dict(batch_size=3, augment=True, shuffle=True,
                                                 repeat=True, seed=5), SMALL, 9),
    "multiscale_uint8": ("synthetic", dict(batch_size=2, augment=True, shuffle=True, seed=6,
                                           uint8_images=True),
                         dict(SMALL, multiscale_min_sizes=(48, 64, 72)), None),
    "shard0": ("synthetic", dict(batch_size=2, shuffle=True, seed=7, shard_id=0, num_shards=2),
               SMALL, None),
    "shard1": ("synthetic", dict(batch_size=2, shuffle=True, seed=7, shard_id=1, num_shards=2),
               SMALL, None),
    "concat": ("concat", dict(batch_size=2, shuffle=True, seed=8, workers=3), SMALL, None),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_the_jax_package(case, voc_root, generic_cv2):
    kind, kw, img_kw, limit = LOADER_CASES[case]
    ours_ds, theirs_ds = _datasets(kind, voc_root)
    ours = DetectionLoader(ours_ds, image_cfg=ImageConfig(**img_kw), **kw)
    theirs = jax_data.DetectionLoader(theirs_ds, image_cfg=JaxImageConfig(**img_kw), **kw)
    assert len(ours) == len(theirs)
    got, want = [], []
    for out, loader in ((got, ours), (want, theirs)):
        for b in loader:
            out.append(b)
            if limit and len(out) == limit:
                break
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.ids == w.ids
        for k in ("images", "im_info", "gt_boxes", "gt_labels", "gt_valid"):
            assert _equal(getattr(g, k), getattr(w, k)), (case, k)
    if case == "partial_flush":
        assert len(set(got[-1].ids)) < len(got[-1].ids)       # padded by repetition
