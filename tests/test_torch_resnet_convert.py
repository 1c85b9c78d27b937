"""The port's ResNet-101 importer against the JAX package's.

The fabricated torchvision tree of tests/test_resnet_convert.py (every
ResNet-101 tensor, random values) goes through JAX ``import_resnet101_npz``
+ ``trcnn_torch.convert.flax_to_state_dict`` on one side and through
``trcnn_torch.convert_resnet.import_resnet101_npz`` on the other: the
tensors must be identical, with the conv1 preprocessing fold on and off,
and for the same tree renamed to chainercv's scheme with the detector's
RPN and output layers added.
"""

import numpy as np
import pytest
import torch

from tests.test_resnet_convert import _fake_torchvision_sd
from trcnn.convert.resnet_npz import import_resnet101_npz as jax_import
from trcnn_torch.config import voc_config
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.convert_resnet import detect_source, import_resnet101_npz
from trcnn_torch.models import make_model
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)


def _chainercv(sd, rng):
    """The torchvision tree under chainercv's names, plus RPN convolutions
    and the head's output layers (one without a bias)."""
    bn = {"weight": "gamma", "bias": "beta", "running_mean": "avg_mean",
          "running_var": "avg_var"}
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0].startswith("layer"):
            stage = f"res{int(parts[0][5:]) + 1}"
            bi = int(parts[1])
            block = "a" if bi == 0 else f"b{bi}"
            if parts[2] == "downsample":
                name = "conv4/W" if parts[3] == "0" else f"bn4/{bn[parts[4]]}"
            elif parts[2].startswith("conv"):
                name = f"{parts[2]}/W"
            else:
                name = f"{parts[2]}/{bn[parts[3]]}"
            out[f"{stage}/{block}/{name}"] = v
        elif parts[0] == "conv1":
            out["conv1/W"] = v
        else:
            out[f"bn1/{bn[parts[1]]}"] = v
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    out.update({"rpn/rpn_conv_3x3/W": f32(16, 1024, 3, 3), "rpn/rpn_conv_3x3/b": f32(16),
                "rpn/rpn_cls_score/W": f32(18, 16, 1, 1), "rpn/rpn_cls_score/b": f32(18),
                "rpn/rpn_bbox_pred/W": f32(36, 16, 1, 1), "rpn/rpn_bbox_pred/b": f32(36),
                "head/cls_score/W": f32(21, 2048), "head/cls_score/b": f32(21),
                "head/bbox_pred/W": f32(84, 2048)})
    return out


@pytest.mark.parametrize("source,fold", [("torchvision", None), ("torchvision", False),
                                         ("chainercv", None), ("chainercv", True)])
def test_importer_matches_the_jax_package(source, fold):
    rng = np.random.RandomState(0)
    sd = _fake_torchvision_sd(rng)
    if source == "chainercv":
        sd = _chainercv(sd, rng)
    assert detect_source(sd) == source
    want = flax_to_state_dict(jax_import(sd, fold_preprocess=fold))
    got = import_resnet101_npz(sd, fold_preprocess=fold)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    w = got["extractor.conv1.weight"].numpy()
    folded = fold if fold is not None else source == "torchvision"
    raw = sd["conv1.weight" if source == "torchvision" else "conv1/W"]
    assert np.array_equal(w, raw) != folded
    if source == "chainercv":
        assert "rpn.rpn_conv.bias" in got and "head.bbox_pred.bias" not in got


def test_imported_trunk_loads_into_the_model():
    """An ImageNet trunk fills every backbone and res5 slot of the R101
    model with the right shape; only the RPN and the output layers are
    left to the init."""
    got = import_resnet101_npz(_fake_torchvision_sd(np.random.RandomState(1)))
    model = make_model(voc_config().replace(backbone="resnet101"), device="cpu")
    result = model.load_state_dict(got, strict=False)
    assert not result.unexpected_keys
    assert {k.split(".")[1] if k.startswith("head") else k.split(".")[0]
            for k in result.missing_keys} == {"rpn", "cls_score", "bbox_pred"}
    assert torch.equal(model.head.res5.block3.bn3.var, got["head.res5.block3.bn3.var"])
    with pytest.raises(KeyError):
        import_resnet101_npz({"conv1.weight": got["extractor.conv1.weight"].numpy()})
