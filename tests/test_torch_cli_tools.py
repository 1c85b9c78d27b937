"""The port's convert, download and parity CLIs (``trcnn_torch.cli.
{convert,download,parity}``) against the JAX package's scripts, on the CPU.

- convert / download: on tests/test_convert.py's fabricated Chainer tree,
  the port's flat flax npz equals the JAX script's key for key, bit for
  bit (the JAX scripts' ``main`` runs in this process with a patched
  ``sys.argv``); ``to_chainer`` then ``to_flax`` gives the same npz back;
  a missing tensor raises without ``--loose`` and is skipped with it;
- parity, at the tiny config (``trcnn_torch.entry.tiny_config``, 64 x 96
  canvases) from a seeded tiny VGG-16 exported as a Chainer npz (graded
  class biases, so that random weights make detections): capture, then
  compare with zero deltas; a changed weight fails the golden check; the
  VOC gate's exit codes on the two-image VOC tree of
  tests/test_torch_cli.py; a golden written from the JAX package's own
  detections (JAX's ``Evaluator.collect_detections`` at batch 1 on the
  same npz through JAX's importer, rounded as ``scripts/parity.py``
  rounds) is read by the port's harness and passes its default
  tolerances (0.1 pixel, 1e-3 in score).

The goldens always go under the test's temporary directory: the repo
root's ``parity_goldens.json`` is never read or written.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_convert import _fake_chainer_tree
from trcnn_torch.cli import convert, download, parity
from trcnn_torch.convert_chainer import export_chainer_npz
from trcnn_torch.entry import tiny_config
from trcnn_torch.models import make_model
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 32
REPORT_KEYS = {"weights", "dataset", "n_images", "golden", "mAP", "per_class", "pass"}


def _jax_script(name: str, argv, monkeypatch) -> int:
    """``scripts/<name>.py``'s ``main()`` in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    return mod.main()


def _npz_equal(a: str, b: str) -> None:
    x, y = dict(np.load(a)), dict(np.load(b))
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
        assert x[k].tobytes() == y[k].tobytes(), k


@pytest.fixture(scope="module")
def chainer_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    path = str(d / "VGG16_faster_rcnn_final.npz")
    np.savez(path, **_fake_chainer_tree(np.random.RandomState(0), hidden=HIDDEN))
    return d, path


def test_convert_to_flax_equals_the_jax_script(chainer_npz, monkeypatch, capsys):
    """``--direction to_flax`` (and ``--no_bbox_normalize``): the port's npz
    is the JAX script's, key for key and bit for bit."""
    d, src = chainer_npz
    for extra in ([], ["--no_bbox_normalize"]):
        ours, theirs = str(d / "ours.npz"), str(d / "theirs.npz")
        argv = ["--src", src, "--direction", "to_flax", "--head_hidden", str(HIDDEN)] + extra
        assert convert.main(argv + ["--dst", ours]) == 0
        assert _jax_script("convert_weights", argv + ["--dst", theirs], monkeypatch) == 0
        _npz_equal(ours, theirs)
    out = capsys.readouterr().out
    assert out.count("wrote 40 tensors") == 4
    assert "params/head/fc6/kernel" in np.load(ours)


def test_convert_to_chainer_round_trips(chainer_npz):
    """to_flax, to_chainer, to_flax: the second flax npz is the first, bit
    for bit, and the flat tree loads back into the port's state_dict."""
    d, src = chainer_npz
    first, back, again = (str(d / n) for n in ("first.npz", "back.npz", "again.npz"))
    common = ["--head_hidden", str(HIDDEN)]
    assert convert.main(["--src", src, "--dst", first, "--direction", "to_flax"] + common) == 0
    assert convert.main(["--src", first, "--dst", back, "--direction", "to_chainer"] + common) == 0
    assert convert.main(["--src", back, "--dst", again, "--direction", "to_flax"] + common) == 0
    _npz_equal(first, again)
    tree = convert.load_flax_npz(first)
    assert convert.flatten(tree).keys() == dict(np.load(first)).keys()


def test_convert_missing_tensor_raises_without_loose(chainer_npz, monkeypatch):
    """A tree without fc7: KeyError without ``--loose``, as the JAX script;
    with it, the rest is written, equal to the JAX script's."""
    d, _ = chainer_npz
    tree = _fake_chainer_tree(np.random.RandomState(1), hidden=HIDDEN)
    del tree["fc7/W"], tree["fc7/b"]
    src = str(d / "no_fc7.npz")
    np.savez(src, **tree)
    argv = ["--src", src, "--direction", "to_flax", "--head_hidden", str(HIDDEN)]
    with pytest.raises(KeyError, match="fc7"):
        convert.main(argv + ["--dst", str(d / "x.npz")])
    ours, theirs = str(d / "loose_ours.npz"), str(d / "loose_theirs.npz")
    assert convert.main(argv + ["--loose", "--dst", ours]) == 0
    assert _jax_script("convert_weights", argv + ["--loose", "--dst", theirs], monkeypatch) == 0
    _npz_equal(ours, theirs)
    assert not any("fc7" in k for k in np.load(ours))


def test_download_converts_a_file_as_the_jax_script(chainer_npz, monkeypatch, capsys):
    """``--file`` on disk (the VOC config, missing layers skipped): the same
    flat npz as the JAX script's; no ``--file``: the sources printed, exit
    1; a missing file: exit 1."""
    d, src = chainer_npz
    ours, theirs = str(d / "dl_ours.npz"), str(d / "dl_theirs.npz")
    assert download.main(["--file", src, "--out", ours]) == 0
    assert _jax_script("download_weights", ["--file", src, "--out", theirs], monkeypatch) == 0
    _npz_equal(ours, theirs)
    capsys.readouterr()
    assert download.main([]) == 1
    out = capsys.readouterr().out
    assert "mitmul/chainer-faster-rcnn" in out and "no --file given" in out
    assert download.main(["--file", str(d / "absent.npz")]) == 1


# ---------------------------------------------------------------- parity


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """A seeded tiny VGG-16 (classes' biases graded from -3 to 3) exported
    as a Chainer npz."""
    d = tmp_path_factory.mktemp("parity")
    cfg = tiny_config()
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.head.cls_score.bias.copy_(torch.linspace(-3.0, 3.0, cfg.num_classes))
    path = str(d / "tiny.npz")
    export_chainer_npz(model.state_dict(), path, cfg)
    return d, path


def _smoke(npz, golden, *extra):
    return ["--dataset", "synthetic", "--cpu", "--reference_npz", npz, "--golden", golden,
            "--golden_images", "2", "--limit", "4", "--batch_size", "2", *extra]


def test_parity_captures_then_compares_with_zero_deltas(tiny_npz, capsys):
    d, npz = tiny_npz
    golden, report = str(d / "goldens.json"), str(d / "report.json")
    assert parity.main(_smoke(npz, golden, "--out", report)) == 0
    assert "captured 2-image goldens" in capsys.readouterr().out
    saved = json.load(open(golden))
    assert len(saved) == 2 and sum(len(g["scores"]) for g in saved.values()) > 0
    assert parity.main(_smoke(npz, golden, "--out", report)) == 0
    out = capsys.readouterr().out
    assert "golden check: 2 images" in out and "→ OK" in out and "not gated" in out
    rep = json.load(open(report))
    assert set(rep) == REPORT_KEYS and rep["pass"] is True and rep["n_images"] == 4
    assert rep["golden"] == {"compared": 2, "max_box_delta": 0.0, "max_score_delta": 0.0,
                             "mismatches": [], "ok": True}


def test_parity_changed_weight_fails_the_golden_check(tiny_npz):
    """The golden of the npz against a copy whose bbox_pred x-offset bias
    moved by 0.02: nonzero box deltas past 0.1 pixel, ``ok`` false (smoke
    mode is never gated, so the exit stays 0)."""
    d, npz = tiny_npz
    golden = str(d / "goldens_changed.json")
    assert parity.main(_smoke(npz, golden)) == 0
    tree = dict(np.load(npz))
    tree["bbox_pred/b"] = tree["bbox_pred/b"].copy()
    tree["bbox_pred/b"][0::4] += 0.02
    moved = str(d / "moved.npz")
    np.savez(moved, **tree)
    rep = parity.run(_smoke(moved, golden))
    g = rep["golden"]
    assert g["ok"] is False and g["max_box_delta"] > 0.1 and rep["exit"] == 0, g


def test_parity_voc_gate_exit_codes(tiny_npz, monkeypatch, capsys):
    """``--dataset voc`` on the two-image VOC tree (the tiny config in place
    of the VOC one): ``--target_map 1.0`` fails (exit 2, ``PARITY FAIL``),
    ``--target_map 0`` passes (exit 0)."""
    pytest.importorskip("cv2")
    from tests.test_arrival_rehearsal import _write_voc_tree

    d, npz = tiny_npz
    root, _ = _write_voc_tree(str(d / "VOC2007"), np.random.RandomState(0))
    monkeypatch.setattr(parity, "make_config", lambda backbone, preset="voc": tiny_config())
    argv = ["--voc_root", root, "--reference_npz", npz, "--cpu", "--golden",
            str(d / "voc_goldens.json"), "--golden_images", "1", "--batch_size", "2"]
    assert parity.main(argv + ["--target_map", "1.0"]) == 2
    assert "PARITY FAIL" in capsys.readouterr().out
    assert parity.main(argv + ["--target_map", "0"]) == 0
    out = capsys.readouterr().out
    assert "golden check: 1 images" in out and "PARITY PASS" in out


def test_parity_reads_a_golden_written_from_jax_detections(tiny_npz):
    """JAX's ``Evaluator.collect_detections`` at batch 1 on the first two
    synthetic images, the npz through JAX's importer, rounded as
    ``scripts/parity.py`` rounds: the port's harness on the same npz reads
    that file and passes its default tolerances."""
    from __graft_entry__ import _tiny_cfg
    from trcnn.convert import import_chainer_npz
    from trcnn.data import SyntheticDetection
    from trcnn.eval import Evaluator
    from trcnn.models import make_model as jax_make_model

    d, npz = tiny_npz
    cfg = _tiny_cfg()
    ds = SyntheticDetection(n=32, num_classes=cfg.num_classes, seed=11,
                            hw_range=((48, 60), (64, 90)))
    dets = Evaluator(jax_make_model(cfg), cfg, ds, batch_size=1, limit=2).collect_detections(
        import_chainer_npz(npz, cfg))
    golden = {x["id"]: {"boxes": np.round(np.asarray(x["boxes"], np.float64), 4).tolist(),
                        "scores": np.round(np.asarray(x["scores"], np.float64), 6).tolist(),
                        "classes": np.asarray(x["classes"], int).tolist()} for x in dets}
    assert sum(len(g["scores"]) for g in golden.values()) > 0
    path = str(d / "jax_goldens.json")
    with open(path, "w") as f:
        json.dump(golden, f, indent=1)
    rep = parity.run(_smoke(npz, path))
    assert rep["golden"]["compared"] == 2 and rep["golden"]["ok"] is True, rep["golden"]
