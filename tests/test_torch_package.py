"""Package-level checks of the port that need no JAX and no card: imports
stay JAX-free, the entry point runs its graph on the CPU at a small config,
and a tensor on any device other than the CPU reaches a kernel or raises."""

import os
import subprocess
import sys

import pytest
import torch

from trcnn_torch import _build
from trcnn_torch.entry import entry
from trcnn_torch.ops import nms, roi_pool, stem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, trcnn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(trcnn_torch.__path__, 'trcnn_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 14, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "ours = {m for m in sys.modules if m.split('.')[0] == 'trcnn'}\n"
        "assert ours <= {'trcnn', 'trcnn.config'}, ours\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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
    # the kernel wrappers refuse CPU tensors outright
    with pytest.raises(ValueError):
        nms.greedy_keep_cuda(torch.zeros((8, 4)), torch.ones(8, dtype=torch.bool), 0.7, 4)
    with pytest.raises(ValueError):
        roi_pool.roi_max_pool_cuda(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 2, 4)))
    with pytest.raises(ValueError):
        stem.stem_block1_cuda(torch.zeros((1, 4, 4, 3)), *(
            torch.zeros(s) for s in ((64, 3, 3, 3), (64,), (64, 64, 3, 3), (64,))))


def test_build_key_covers_every_source():
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(f"{k}.cu" for k in _build.KERNELS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.build_dir().parent == _build.BUILD_ROOT
    assert _build.source_hash() == _build.source_hash()
