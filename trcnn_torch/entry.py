"""Entry points: the full image -> detections graph on one device
(counterpart of ``__graft_entry__.entry``), the training step (counterpart
of ``benchmarks/bench_train.py``) and one training step on a (data, model)
grid of processes (``__graft_entry__.dryrun_multichip``).

``entry(device)`` builds the VOC model (608x1024 canvas, im_info (600,
1000, 1.6)) with random weights, casts it for bf16 inference, and returns
``(fn, (model, images, im_info))`` with one uint8 canvas; weights and
canvas are made from seed 0.  ``fn(model, images, im_info)`` runs detect +
postprocess.  ``backbone`` picks VGG-16 (the default) or "resnet101"
(``voc_config().replace(backbone=...)``), as the JAX scripts' ``--backbone``
switch does.  ``quant="int8"`` builds the dynamic int8 model
(``make_model(..., quant="int8")``) and, as ``bench.py`` does, leaves its
weights float32: they are quantized from the float32 parameters.  A
config whose ``roi.mode`` is "align" pools with RoIAlign.

``train_entry(device)`` builds the same model for training (float32 master
parameters, compute in ``dtype``) with its Caffe-order optimizer, and a
device-resident batch: uint8 canvases, two gt boxes per image.  It returns
``(step_fn, (state, batch))``; ``step_fn(state, batch)`` takes one step in
place and returns the metrics.

``dryrun_multichip(n)`` starts n gloo processes on a (n / n_model,
n_model) grid, n_model 2 for an even n of at least 4, takes one step of
:func:`tiny_config` at 2 images per data shard, and asserts that every loss
branch ran.

All run on the card unless the caller asks for the CPU; without a card the
default raises.  Tests pass a small config (:func:`tiny_config` style) to
run the same graphs on the CPU; its im_info is the canvas minus 4 pixels at
unit scale.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import multiprocessing.connection
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from trcnn_torch import parallel
from trcnn_torch.config import (AnchorConfig, FasterRCNNConfig, ImageConfig, ProposalConfig,
                                ProposalTargetConfig, voc_config)
from trcnn_torch.models.faster_rcnn import (Detections, cast_params_for_inference,
                                            make_model, postprocess)
from trcnn_torch.train.step import TrainState, train_step

DRYRUN_TIMEOUT = datetime.timedelta(seconds=300)


def _setup(device, cfg: Optional[FasterRCNNConfig], backbone: Optional[str]):
    """(device, config, im_info row): the VOC config with ``backbone``
    ("vgg16" when None), or ``cfg``, whose backbone ``backbone`` must then
    name if given."""
    device = torch.device(device)
    if cfg is None:
        return (device, voc_config().replace(backbone=backbone or "vgg16"),
                (600.0, 1000.0, 1.6))
    if backbone not in (None, cfg.backbone):
        raise ValueError(f"backbone {backbone!r} differs from the config's {cfg.backbone!r}")
    return device, cfg, (float(cfg.image.pad_h - 4), float(cfg.image.pad_w - 4), 1.0)


def entry(device="cuda", cfg: Optional[FasterRCNNConfig] = None,
          dtype: torch.dtype = torch.bfloat16, backbone: Optional[str] = None,
          quant: str = "none") -> Tuple[Callable[..., Detections], tuple]:
    device, cfg, im_info_row = _setup(device, cfg, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, dtype=dtype, device=device, quant=quant).init(gen)
    if quant == "none":
        cast_params_for_inference(model, dtype)
    model.eval()
    images = torch.randint(0, 256, (1, cfg.image.pad_h, cfg.image.pad_w, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    im_info = torch.tensor([im_info_row], dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(m, x, info) -> Detections:
        return postprocess(m.detect(x, info), info, cfg)

    return fn, (model, images, im_info)


# bench_train.py's gt: two boxes per image, classes 3 and 7, in canvas
# coordinates of the 600 x 1000 image
TRAIN_GT_BOXES = ((40.0, 60.0, 300.0, 280.0), (350.0, 100.0, 600.0, 420.0))
TRAIN_GT_LABELS = (3, 7)


def train_entry(device="cuda", cfg: Optional[FasterRCNNConfig] = None,
                dtype: torch.dtype = torch.bfloat16, batch_size: int = 8,
                backbone: Optional[str] = None
                ) -> Tuple[Callable[..., Dict[str, torch.Tensor]], tuple]:
    """The training step at the VOC config with ``backbone`` (or ``cfg``),
    weights and uint8 canvases from seed 0; the gt boxes are scaled into a
    small config's canvas."""
    device, cfg, im_info_row = _setup(device, cfg, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, dtype=dtype, device=device).init(gen)
    images = torch.randint(0, 256, (batch_size, cfg.image.pad_h, cfg.image.pad_w, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    gt = torch.tensor(TRAIN_GT_BOXES, dtype=torch.float32)
    gt = gt * min(1.0, im_info_row[0] / 600.0, im_info_row[1] / 1000.0)
    batch = {
        "images": images,
        "im_info": torch.tensor([im_info_row], dtype=torch.float32).expand(batch_size, 3),
        "gt_boxes": gt.expand(batch_size, -1, -1),
        "gt_labels": torch.tensor(TRAIN_GT_LABELS, dtype=torch.int32).expand(batch_size, -1),
        "gt_valid": torch.ones((batch_size, len(TRAIN_GT_LABELS)), dtype=torch.bool),
    }
    batch = {k: v.contiguous().to(device) for k, v in batch.items()}
    return train_step, (TrainState.create(model), batch)


def tiny_config() -> FasterRCNNConfig:
    """``__graft_entry__._tiny_cfg``: fc6/fc7 width 64, 32 RPN channels, a
    64 x 96 canvas, 192 -> 48 training proposals, 16 RoIs per image, and
    anchor scales (1, 2, 3), since the default scales make anchors that all
    fall outside such a canvas and would zero the RPN losses."""
    return FasterRCNNConfig(
        head_hidden=64, rpn_channels=32, anchors=AnchorConfig(scales=(1.0, 2.0, 3.0)),
        proposals=ProposalConfig(pre_nms_topk_train=192, post_nms_topk_train=48,
                                 pre_nms_topk_test=192, post_nms_topk_test=24),
        proposal_targets=ProposalTargetConfig(rois_per_image=16),
        image=ImageConfig(target_min_size=48, target_max_size=96, pad_h=64, pad_w=96))


def _dryrun_rank(store: str, n: int, n_model: int, rank: int, device: str, out: str) -> None:
    """One rank of :func:`dryrun_multichip`: its metrics into ``out``
    (JSON)."""
    cuda = torch.device(device).type == "cuda"
    if not cuda:
        torch.set_num_threads(1)          # the ranks share the host's cores
    dev = parallel.initialize(store, n, rank, backend="gloo", timeout=DRYRUN_TIMEOUT,
                              local_device_ids=[rank % torch.cuda.device_count()] if cuda
                              else None)
    try:
        mesh = parallel.make_mesh(n // n_model, n_model)
        cfg = tiny_config()
        h, w = cfg.image.pad_h, cfg.image.pad_w
        b = 2 * mesh.n_data                     # 2 images per data shard
        gen = torch.Generator(device=dev).manual_seed(0)
        model = make_model(cfg, device=dev).init(gen)
        gt = torch.tensor([[5.0, 5.0, 40.0, 40.0], [10.0, 20.0, 60.0, 50.0]], device=dev)
        batch = {"images": torch.randn((b, h, w, 3), generator=gen, device=dev),
                 "im_info": torch.tensor([[float(h), float(w), 1.0]], device=dev).expand(b, 3),
                 "gt_boxes": gt.expand(b, 2, 4),
                 "gt_labels": torch.tensor([[3, 7]], dtype=torch.int32, device=dev).expand(b, 2),
                 "gt_valid": torch.ones((b, 2), dtype=torch.bool, device=dev)}
        i = mesh.data_index
        batch = {k: v[2 * i:2 * i + 2].contiguous() for k, v in batch.items()}
        state = TrainState.create(model, mesh)
        metrics = {k: float(v) for k, v in train_step(state, batch, seed=1).items()}
        with open(out, "w") as f:
            json.dump(metrics, f)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, float]:
    """One training step on a grid of ``n_devices`` gloo processes, the
    counterpart of ``__graft_entry__.dryrun_multichip``: the model axis is
    2 for an even count of at least 4, else 1; each data shard takes 2
    images of :func:`tiny_config` (seeded weights and images, two gt boxes
    each).  Every rank runs on ``device``: the card (each rank on card
    ``rank % count``, all on card 0 with one card) unless the caller asks
    for the CPU.  Asserts that fg anchors and RoIs were sampled, that all
    four losses and ``grad_norm`` are positive, prints the metrics and
    returns them (rank 0's: every rank holds the global batch's).  A rank
    that fails stops the others; so does the time limit."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu' for the CPU)")
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    print(f"grid: data {n_devices // n_model} x model {n_model}, {device}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dryrun_rank, args=(
            f"file://{tmp}/store", n_devices, n_model, r, str(device), f"{tmp}/{r}.json"))
            for r in range(n_devices)]
        deadline = time.monotonic() + 2 * DRYRUN_TIMEOUT.total_seconds()
        try:
            for p in procs:
                p.start()
            alive = procs
            while alive and time.monotonic() < deadline and not any(p.exitcode for p in procs):
                multiprocessing.connection.wait([p.sentinel for p in alive],
                                                deadline - time.monotonic())
                alive = [p for p in alive if p.exitcode is None]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"dryrun_multichip: ranks failed or timed out (exit codes "
                               f"{failed})")
        with open(f"{tmp}/0.json") as f:
            m = json.load(f)
    # the sharded step must exercise every loss branch, not just run
    zero = [k for k in ("num_fg_anchors", "num_fg_rois", "rpn_cls_loss", "rpn_bbox_loss",
                        "cls_loss", "bbox_loss", "grad_norm") if not m[k] > 0]
    if zero:
        raise AssertionError(f"dryrun_multichip: {zero} not positive, a branch not "
                             f"exercised: {m}")
    print("dryrun_multichip ok:", m, flush=True)
    return m
