"""The controls, on the card at each cell's own size: what a run compares,
computed one precision below the configuration's bf16, has to come out
not correct at the cell's limits.

- vgg16_voc.detect_b8: the port's own int8 path (``quant="int8"``) in
  place of its bf16 path, and the fp8 reference below (the int8 path
  quantizes the convolutions and fc6/fc7 alone, so that it reads no more
  than bf16 does on the RPN and the head);
- r101_c4_coco.detect_b8 and both train cells: the float32 reference with
  every convolution's and product's inputs rounded to float8 e4m3 put in
  the port's place (the port has no lower-precision path there; int8
  trains nothing).

Run on the card with ``python -m pytest -m gpu -s
bench_port/tests/test_bench_port_control.py``; each case prints its
numbers beside the limits.  Skips without a card."""

import json
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

from bench_port import check, harness, traffic
from bench_port.reference import boxes as rb
from bench_port.reference import nets
from bench_port.reference import train as rt

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
CELLS = ("vgg16_voc.detect_b8", "r101_c4_coco.detect_b8", "vgg16_voc.train_b8",
         "r101_c4_coco.train_b8")
CONTROLS = (("vgg16_voc.detect_b8", "int8"), ("vgg16_voc.detect_b8", "fp8"),
            ("r101_c4_coco.detect_b8", "fp8"), ("vgg16_voc.train_b8", "fp8"),
            ("r101_c4_coco.train_b8", "fp8"))


class Raw(NamedTuple):
    rois: torch.Tensor
    roi_valid: torch.Tensor
    cls_prob: torch.Tensor
    bbox_pred: torch.Tensor


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the controls run on the card")
    return "cuda"


def fp8_detect(cfg, w, batch) -> check.DetectCapture:
    """The reference in fp8 in the port's place: its features, RPN outputs,
    proposals, head outputs on its own crops, and epilogue."""
    net = nets.Net.for_config(dict(w), cfg, quant="fp8")
    images, info = batch["images"], batch["im_info"]
    cap = check.DetectCapture()
    with nets.float32_exact(), torch.inference_mode():
        cap.feat = net.trunk(nets.prepare(images, info, cfg.image.pixel_means_bgr))
        cap.fg_probs, _, cap.deltas = net.rpn(cap.feat)
        rois, valid = rb.proposals(cap.fg_probs, cap.deltas, info, cfg, train=False)
        rois, valid = torch.from_numpy(rois).to(images.device), torch.from_numpy(valid).to(
            images.device)
        crops = nets.pool(net, cap.feat, rois, cfg.roi.mode, cfg.roi.spatial_scale)
        cap.crops = crops[cap.crop_rows(crops.shape[0])]
        cs, bp = net.head_chunked(crops)
        del crops
        b, r = valid.shape
        cap.raw = Raw(rois, valid, torch.softmax(cs, -1).reshape(b, r, -1), bp.reshape(b, r, -1))
        cap.dets = tuple(torch.from_numpy(a) for a in rb.postprocess(*cap.raw, info, cfg))
    return cap


def control_numbers(cell_name, seed, device, control="fp8", root=ROOT,
                    bench_dir=harness.HERE):
    cell = harness.load_cell(root, cell_name, bench_dir)
    cfg = harness.model_config(cell.config)
    kind = cell.traffic["kind"]
    t = dict(cell.traffic, pool_batches=3 if kind == "train" else 1)
    pool = traffic.make_pool(t, cfg, cell.config["batch_size"], cell.config["gt_capacity"],
                             seed, device)
    w = harness.make_weights(cfg, seed, pool, device)
    if kind == "detect":
        batch = pool[0]
        if control == "int8":
            model = harness.build_model(cfg, cell.config, w, kind, device, quant="int8")
            cap = check.DetectCapture()
            handles = cap.hooks(model)
            cap.raw, cap.dets = harness.detect_call(model, batch, cfg)
            for h in handles:
                h.remove()
            del model
        else:
            cap = fp8_detect(cfg, w, batch)
        numbers = check.detect_numbers(cap, batch["images"], batch["im_info"], w, cfg)
    else:
        net = nets.Net.for_config(dict(w), cfg)
        props = []
        with nets.float32_exact(), torch.no_grad():
            for b in pool:
                fg, _, dl = net.rpn(net.trunk(nets.prepare(b["images"], b["im_info"],
                                                           cfg.image.pixel_means_bgr)))
                props.append(rb.proposals(fg, dl, b["im_info"], cfg, train=True))
        dtype = getattr(torch, cell.config["dtype"])
        w0 = {k: v.to("cpu", copy=True) for k, v in w.items()}
        runs = {}
        for quant in ("fp8", "none"):
            wq = {k: v.to(device, copy=True) for k, v in w0.items()}
            with nets.float32_exact():
                losses, grad = rt.run_steps(wq, cfg, pool, props, seed % 2 ** 31, dtype,
                                            quant)
            runs[quant] = (losses, {k: g.cpu() for k, g in grad.items()},
                           {k: wq[k].cpu() - w0[k] for k in w0})
            del wq
        numbers, _ = check.train_numbers(*runs["fp8"], *runs["none"], cfg.backbone)
    return numbers, check.judge(numbers, cell.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(card, cell, control, seed):
    numbers, (correct, rows, readings) = control_numbers(cell, seed, card, control)
    print(json.dumps({"control": cell, "precision": control, "seed": seed, "checks": rows,
                      "readings": readings}), flush=True)
    torch.cuda.empty_cache()
    assert not correct, rows


# the faults a cell can have, planted under the timed path of a whole run at
# the cell's own size (a state left unchanged reads 1 by the measure and
# needs no run)
FAULTS = {"vgg16_voc.detect_b8": ("answer_altered",), "r101_c4_coco.detect_b8": ("answer_altered",),
          "vgg16_voc.train_b8": ("half_batch",), "r101_c4_coco.train_b8": ("half_batch",)}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(card, monkeypatch, cell, seed):
    from bench_port.tests import test_bench_port_extend as faults

    for fault in FAULTS[cell]:
        with monkeypatch.context() as m:
            faults.plant(m, fault)
            res = harness.run(harness.load_cell(ROOT, cell), seed, 2.0, False, card)
        print(json.dumps({"fault": fault, "cell": cell, "seed": seed, "checks": res["checks"],
                          "readings": res["readings"]}), flush=True)
        torch.cuda.empty_cache()
        assert "check_error" not in res, res["check_error"]
        assert not res["correct"]
