"""Package-level checks of the port that need no card: imports load nothing
of JAX or of the JAX package, the config copy equals the JAX package's,
the entry point runs its graph on the CPU at a small config, the entry
points default to the card, and a tensor on any device other than the CPU
reaches a kernel or raises."""

import argparse
import dataclasses
import inspect
import os
import subprocess
import sys

import pytest
import torch

from trcnn import config as jax_config
from trcnn_torch import _build, config
from trcnn_torch.cli import add_common_flags, evaluate, forward, parity, train
from trcnn_torch.entry import dryrun_multichip, entry, train_entry
from trcnn_torch.eval import Evaluator
from trcnn_torch.models import make_model, resnet
from trcnn_torch.ops import frozen_bn, nms, quant, roi_align, roi_pool, stem
from trcnn_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torch threads per test process: the suite runs several worker processes on
# one machine's cores, and more threads per worker only oversubscribe them
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """TORCH_THREADS torch threads for a module's tests, the setting
    restored after; the port's other test modules import it."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def test_port_imports_no_jax():
    """Every module of the port, the data layer and the CLIs included,
    imports without loading JAX, flax, optax, clu or the JAX package, and
    without cv2 or PIL (the image libraries load only when a file is read
    or written)."""
    code = (
        "import importlib, pkgutil, sys, trcnn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(trcnn_torch.__path__, 'trcnn_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 54, names\n"
        "for n in ('cli.forward', 'cli.evaluate', 'cli.train', 'data.loader', 'eval.evaluator',\n"
        "          'convert_chainer', 'convert_caffemodel', 'weights', 'data.coco',\n"
        "          'eval.coco_ap', 'ops.roi_align', 'ops.quant', 'parallel', 'parallel.tensor',\n"
        "          'cli.convert', 'cli.download', 'cli.parity', 'ops.native', 'utils',\n"
        "          'utils.profiling', 'utils.debug'):\n"
        "    assert 'trcnn_torch.' + n in names, n\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'clu', 'trcnn', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("make", ["voc_config", "coco_config"])
def test_config_copy_equals_the_jax_package(make):
    ours, theirs = getattr(config, make)(), getattr(jax_config, make)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.anchors.num_anchors == theirs.anchors.num_anchors
    assert ours.proposals.pre_nms_topk(True) == theirs.proposals.pre_nms_topk(True)


def test_entry_points_default_to_the_card():
    for fn in (make_model, entry, train_entry, dryrun_multichip, Trainer.__init__,
               Evaluator.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for cli in (forward, evaluate, train):          # --device defaults to the card
        ap = argparse.ArgumentParser()
        add_common_flags(ap)
        assert ap.parse_args([]).device == "cuda"
        assert cli.add_common_flags is add_common_flags
    assert parity.parse(["--dataset", "synthetic"]).device == "cuda"
    assert parity.parse(["--dataset", "synthetic", "--cpu"]).device == "cpu"
    if not torch.cuda.is_available():      # nothing falls back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            make_model(_tiny_cfg())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(4)


def _tiny_cfg():
    sys.path.insert(0, REPO)
    from __graft_entry__ import _tiny_cfg as cfg

    return cfg()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_small_config_on_cpu(dtype):
    cfg = _tiny_cfg()
    fn, (model, image, info) = entry("cpu", cfg=cfg, dtype=dtype)
    assert image.dtype == torch.uint8 and image.shape == (1, 64, 96, 3)
    images = torch.cat([image, image.flip(2)])          # two images per call
    im_info = torch.cat([info, info - torch.tensor([[8.0, 16.0, 0.0]])])
    assert model.extractor.conv1_1.weight.dtype == dtype
    assert model.head.cls_score.weight.dtype == torch.float32
    dets = fn(model, images, im_info)
    d = cfg.test.max_dets_per_image
    assert dets.boxes.shape == (2, d, 4) and dets.classes.dtype == torch.int32
    assert torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()
    assert dets.valid.any()
    cls = dets.classes[dets.valid]
    assert ((cls >= 1) & (cls < cfg.num_classes)).all()


def test_non_cpu_tensors_never_take_the_plain_path():
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        nms.greedy_keep(meta, torch.empty(8, dtype=torch.bool, device="meta"), 0.7, 4)
    with pytest.raises(ValueError):
        roi_pool.roi_max_pool(torch.empty((1, 4, 4, 8), device="meta"),
                              torch.empty((1, 2, 4), device="meta"))
    with pytest.raises(ValueError):
        stem.stem_block1(torch.empty((1, 4, 4, 3), device="meta"), *(
            torch.empty(s, device="meta") for s in ((64, 3, 3, 3), (64,), (64, 64, 3, 3), (64,))))
    with pytest.raises(ValueError):
        roi_align.roi_align(torch.empty((1, 4, 4, 8), device="meta"),
                            torch.empty((1, 2, 4), device="meta"))
    with pytest.raises(ValueError):
        quant.int8_matmul(torch.empty((32, 16), dtype=torch.int8, device="meta"),
                          torch.empty((8, 16), dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError):
        frozen_bn.frozen_bn(torch.empty((1, 8, 4, 4), device="meta"),
                            resnet.FrozenBatchNorm(8, device="meta"))
    # the kernel wrappers refuse CPU tensors outright
    with pytest.raises(ValueError):
        nms.greedy_keep_cuda(torch.zeros((8, 4)), torch.ones(8, dtype=torch.bool), 0.7, 4)
    with pytest.raises(ValueError):
        roi_pool.roi_max_pool_cuda(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError):
        roi_pool.roi_pool_backward_cuda(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 2, 4)),
                                        torch.zeros((1, 2, 7, 7, 8)))
    with pytest.raises(ValueError):
        stem.stem_block1_cuda(torch.zeros((1, 4, 4, 3)), *(
            torch.zeros(s) for s in ((64, 3, 3, 3), (64,), (64, 64, 3, 3), (64,))))
    with pytest.raises(ValueError):
        roi_align.roi_align_cuda(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError):
        frozen_bn.frozen_bn_cuda(torch.zeros((1, 8, 4, 4)), *torch.ones((4, 8)), 1e-5)
    with pytest.raises(ValueError):
        roi_align.roi_align_backward_cuda((1, 4, 4, 8), torch.float32, torch.zeros((1, 2, 4)),
                                          torch.zeros((1, 2, 7, 7, 8)))


def test_build_key_covers_every_source(tmp_path, monkeypatch):
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(f"{k}.cu" for k in _build.KERNELS)
    # a shared header is part of the key: editing it rebuilds K2 and K4
    key = _build.source_hash()
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    (tmp_path / "roi_bins.cuh").write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() != key
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.build_dir().parent == _build.BUILD_ROOT
    assert _build.source_hash() == _build.source_hash()
