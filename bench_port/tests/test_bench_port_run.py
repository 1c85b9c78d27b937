"""run.py without a card, and the check for the JAX package's modules."""

import json
import os
import subprocess
import sys
from pathlib import Path

from bench_port import run

ROOT = Path(__file__).resolve().parents[2]


def test_run_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "vgg16_voc.detect_b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "trcnn_torch_like", object())
    assert "trcnn" not in run.forbidden_modules() or "trcnn" in {
        m.split(".", 1)[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "trcnn.ops.nms", object())
    assert "trcnn" in run.forbidden_modules()


def test_harness_modules_import_neither_jax_nor_the_package():
    code = ("import sys; sys.path.insert(0, '.'); import bench_port.harness, bench_port.check, "
            "bench_port.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'trcnn', 'trcnn_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert json.loads(p.stdout.strip().replace("'", '"')) == []
