"""The port's weight importers against the JAX package's, on the CPU
(numpy only: no JAX graph is compiled).

The Chainer npz and caffemodel importers of the port must give, tensor for
tensor and bit for bit, what the JAX importer followed by the bridge
``trcnn_torch.convert.flax_to_state_dict`` gives: on the fabricated Chainer
tree of tests/test_convert.py (a full detector, and its trunk alone with
``strict=False``) and on the same tree written as a caffemodel in both wire
encodings with the byte builders of tests/test_caffemodel.py.  Export then
import is the identity; ``merge_params`` overlays a partial import as the
JAX package's does; ``import_weights`` dispatches the three formats.
"""

import numpy as np
import pytest
import torch

from tests.test_caffemodel import _layer_modern, _layer_v1
from tests.test_convert import _fake_chainer_tree
from tests.test_resnet_convert import _fake_torchvision_sd
from trcnn import convert as jax_convert
from trcnn.config import voc_config as jax_voc_config
from trcnn_torch.config import voc_config
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.convert_caffemodel import import_caffemodel
from trcnn_torch.convert_chainer import (export_chainer_npz, import_chainer_npz, merge_params,
                                         permute_fc6_kernel)
from trcnn_torch.models import make_model
from trcnn_torch.weights import import_weights
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

HIDDEN = 32


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(_bits(got[k]), _bits(v)), k


def _tree(part):
    t = _fake_chainer_tree(np.random.RandomState(0), hidden=HIDDEN)
    if part == "trunk":
        t = {k: v for k, v in t.items() if k.startswith("trunk/")}
    return t


def _caffemodel(tree, encoding):
    """The tree under caffe's layer names ("conv1_1", "rpn_conv/3x3", ...)
    as NetParameter bytes."""
    layer = _layer_modern if encoding == "modern" else _layer_v1
    net = b""
    for name in sorted({k.rsplit("/", 1)[0] for k in tree}):
        cname = name.split("/", 1)[1] if name.startswith(("trunk/", "rpn/")) else name
        cname = cname.replace("rpn_conv_3x3", "rpn_conv/3x3")
        blobs = [tree[f"{name}/W"]] + ([tree[f"{name}/b"]] if f"{name}/b" in tree else [])
        net += layer(cname, blobs)
    return net


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("part", ["full", "trunk"])
def test_chainer_import_matches_the_jax_package(part, normalize):
    tree = _tree(part)
    strict = part == "full"
    want = flax_to_state_dict(jax_convert.import_chainer_npz(
        tree, jax_voc_config(), normalize_bbox_pred=normalize, strict=strict))
    got = import_chainer_npz(tree, voc_config(), normalize_bbox_pred=normalize, strict=strict)
    _assert_same(got, want)
    assert len(got) == (2 * 13 + 2 * 3 + 2 * 4 if strict else 2 * 13)
    if part == "full":
        w = tree["fc6/W"].reshape(HIDDEN, 512, 7, 7).transpose(2, 3, 1, 0).reshape(-1, HIDDEN)
        np.testing.assert_array_equal(got["head.fc6.weight"].numpy(), w.T)
        np.testing.assert_array_equal(permute_fc6_kernel(tree["fc6/W"]), w)
    else:
        with pytest.raises(KeyError):
            import_chainer_npz(tree, voc_config())


@pytest.mark.parametrize("encoding", ["modern", "v1"])
@pytest.mark.parametrize("part", ["full", "trunk"])
def test_caffemodel_import_matches_the_jax_package(part, encoding):
    net = _caffemodel(_tree(part), encoding)
    strict = part == "full"
    want = flax_to_state_dict(jax_convert.import_caffemodel(net, jax_voc_config(),
                                                            strict=strict))
    got = import_caffemodel(net, voc_config(), strict=strict)
    _assert_same(got, want)
    _assert_same(got, import_chainer_npz(_tree(part), voc_config(), strict=strict))


@pytest.mark.parametrize("source", ["import", "seeded"])
def test_export_then_import_is_the_identity(tmp_path, source):
    """A state_dict exported to a Chainer npz imports back bit-equal: one
    imported from the fabricated tree, and a seeded model's (whose
    bbox_pred values no float32 npz could carry back exactly).  The npz
    holds what the JAX package's export writes, bbox_pred in float64 whose
    float32 rounding is the JAX package's."""
    cfg = voc_config().replace(head_hidden=HIDDEN)
    if source == "import":
        sd = import_chainer_npz(_tree("full"), cfg)
    else:
        sd = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(4)).state_dict()
        sd["head.bbox_pred.bias"].normal_(0.0, 0.01, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "w.npz")
    export_chainer_npz(sd, path, cfg)
    _assert_same(import_chainer_npz(path, cfg), sd)
    jax_path = str(tmp_path / "jax.npz")
    jax_convert.export_chainer_npz(state_dict_to_flax(sd), jax_path, jax_voc_config())
    with np.load(path) as ours, np.load(jax_path) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for k in theirs.files:
            assert ours[k].dtype == (np.float64 if k.startswith("bbox_pred/") else np.float32)
            np.testing.assert_array_equal(ours[k].astype(np.float32), theirs[k], err_msg=k)


def test_merge_params_overlays_a_partial_import():
    cfg = voc_config().replace(head_hidden=HIDDEN)
    base = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    trunk = import_chainer_npz(_tree("trunk"), cfg, strict=False)
    merged = merge_params(base, trunk)
    want = flax_to_state_dict(jax_convert.merge_params(state_dict_to_flax(base),
                                                       state_dict_to_flax(trunk)))
    _assert_same(merged, want)
    assert merged.keys() == base.keys()
    assert merged["extractor.conv1_1.weight"] is trunk["extractor.conv1_1.weight"]
    assert merged["head.fc6.weight"] is base["head.fc6.weight"]
    with pytest.raises(KeyError):
        merge_params(base, {"head.fc8.weight": torch.zeros(1)})
    with pytest.raises(ValueError):
        merge_params(base, {"head.fc6.weight": torch.zeros(3, 3)})


@pytest.mark.parametrize("fmt", ["caffemodel", "vgg_npz", "r101_npz"])
def test_import_weights_dispatches_like_the_jax_package(fmt, tmp_path):
    cfg, jcfg = voc_config(), jax_voc_config()
    if fmt == "caffemodel":
        path = str(tmp_path / "w.caffemodel")
        with open(path, "wb") as f:
            f.write(_caffemodel(_tree("full"), "modern"))
    elif fmt == "vgg_npz":
        path = str(tmp_path / "w.npz")
        np.savez(path, **_tree("full"))
    else:
        cfg, jcfg = cfg.replace(backbone="resnet101"), jcfg.replace(backbone="resnet101")
        path = str(tmp_path / "r101.npz")
        np.savez(path, **_fake_torchvision_sd(np.random.RandomState(1)))
    got = import_weights(path, cfg)
    _assert_same(got, flax_to_state_dict(jax_convert.import_weights(path, jcfg)))
    assert any(k.startswith("extractor.res4") for k in got) == (fmt == "r101_npz")
