"""The port's three CLIs in-process on the CPU (``--device cpu``), on the
two-image VOC tree of tests/test_arrival_rehearsal.py and the fabricated
Chainer npz of tests/test_convert.py, at the full VOC canvas (608 x 1024).

The npz has the published VGG-16 trunk and RPN but an fc6/fc7 width of 32,
so the CLIs run with the VOC config at ``head_hidden=32`` (the config is
patched; everything else is the CLI's own path).  Its weights are rescaled
as in tests/test_arrival_rehearsal.py so that a random network makes
detections.

- forward: the printed detections equal the port's
  ``postprocess(detect(...))`` on the same canvas and weights, line for
  line; the drawn image is written;
- evaluate: the 20 devkit files are written in the devkit's format, and
  the printed mAP is the port's ``voc_mean_ap`` of those detections;
- train: one step from the npz warm start writes a checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_arrival_rehearsal import _write_voc_tree
from tests.test_convert import _fake_chainer_tree
from trcnn_torch import cli
from trcnn_torch.cli import evaluate, forward, train
from trcnn_torch.config import VOC_CLASSES
from trcnn_torch.convert_chainer import import_chainer_npz
from trcnn_torch.data import VOCDetection
from trcnn_torch.data.image import read_image
from trcnn_torch.data.preprocess import preprocess_image
from trcnn_torch.eval.voc_ap import build_records, voc_mean_ap
from trcnn_torch.models import make_model, postprocess
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

HIDDEN = 32

pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    tree = _fake_chainer_tree(rng, hidden=HIDDEN)
    for k, v in list(tree.items()):
        if k.endswith("/W") and v.ndim == 4:
            tree[k] = (v / v.std() * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
    tree["rpn/rpn_bbox_pred/W"] *= 0.1
    tree["bbox_pred/W"] *= 0.1
    tree["cls_score/b"] = np.linspace(-3.0, 3.0, 21).astype(np.float32)
    npz = str(d / "VGG16_faster_rcnn_final.npz")
    np.savez(npz, **tree)
    root, ids = _write_voc_tree(str(d / "VOC2007"), rng)
    return d, npz, root, ids


def _cfg(backbone="vgg16", preset="voc"):
    return cli.make_config(backbone, preset).replace(head_hidden=HIDDEN)


@pytest.fixture(autouse=True)
def narrow_head(monkeypatch):
    for mod in (forward, evaluate, train):
        monkeypatch.setattr(mod, "make_config", _cfg)


def test_forward_prints_the_port_detections(files, capsys):
    d, npz, root, _ = files
    img_fn = os.path.join(root, "JPEGImages", "000001.jpg")
    out_fn = str(d / "result.jpg")
    assert forward.main(["--img_fn", img_fn, "--out_fn", out_fn, "--pretrained_model", npz,
                         "--score_thresh", "0.0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("inference:") and out[-1] == f"wrote {out_fn}"
    printed = out[2:-1]

    cfg = _cfg()
    model = make_model(cfg, device="cpu")
    model.load_state_dict(import_chainer_npz(npz, cfg))
    canvas, info = preprocess_image(read_image(img_fn), cfg.image)
    with torch.inference_mode():
        info_t = torch.from_numpy(info[None])
        dets = postprocess(model.eval().detect(torch.from_numpy(canvas[None]), info_t), info_t,
                           cfg, score_thresh=0.0)
    want = forward.format_detections(dets)
    assert printed == want and len(want) > 0
    assert out[1].startswith(f"{len(want)} detections")
    assert read_image(out_fn).shape == (375, 500, 3)


def test_evaluate_writes_devkit_files_and_the_mean_ap(files, capsys):
    d, npz, root, ids = files
    dets_dir = str(d / "dets")
    res = evaluate.run(["--dataset", "voc", "--dataset_root", root, "--split", "test",
                        "--pretrained_model", npz, "--batch_size", "2",
                        "--write_dets", dets_dir, "--device", "cpu"])
    assert res["images"] == 2 and res["timing"]["batches"] == {(608, 1024): 1}
    ds = VOCDetection(root, "test", use_difficult=True)
    anns = {a["id"]: a for a in (ds.get_annotation(i) for i in range(len(ds)))}
    mean_ap, _ = voc_mean_ap(build_records(VOC_CLASSES, res["detections"], anns))
    assert res["mAP"] == mean_ap
    assert f"mAP = {mean_ap:.4f}" in capsys.readouterr().out
    names = sorted(os.listdir(dets_dir))
    assert names == sorted(f"comp4_det_test_{c}.txt" for c in VOC_CLASSES[1:])
    lines = [ln.split() for n in names for ln in open(os.path.join(dets_dir, n))]
    assert len(lines) == sum(len(x["scores"]) for x in res["detections"]) > 0
    for parts in lines:
        assert len(parts) == 6 and parts[0] in ids and 0.0 <= float(parts[1]) <= 1.0
        x1, y1, x2, y2 = map(float, parts[2:])
        assert 1.0 <= x1 <= x2 <= 501.0 and 1.0 <= y1 <= y2 <= 376.0
    with pytest.raises(SystemExit):
        evaluate.run(["--dataset", "coco", "--device", "cpu"])


def test_train_takes_a_step_and_writes_a_checkpoint(files, capsys):
    d, npz, root, _ = files
    out = str(d / "train")
    trainer = train.run(["--dataset", "voc", "--dataset_root", root, "--split", "test",
                         "--pretrained_model", npz, "--batch_size", "1", "--iters", "1",
                         "--log_every", "1", "--out", out, "--no_writer", "--device", "cpu"])
    assert trainer.state.step == 1
    assert os.listdir(out) == ["ckpt_00000001.pt"]
    text = capsys.readouterr().out
    assert "warm-start: 40 tensors" in text and '"step": 1' in text
    # the trunk came from the npz and conv1_1-conv2_2 stayed frozen
    want = import_chainer_npz(npz, _cfg())
    got = torch.load(os.path.join(out, "ckpt_00000001.pt"))["model"]
    assert torch.equal(got["extractor.conv1_1.weight"], want["extractor.conv1_1.weight"])
    assert not torch.equal(got["extractor.conv5_3.weight"], want["extractor.conv5_3.weight"])
