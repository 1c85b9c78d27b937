"""End-to-end Faster R-CNN training, the port's counterpart of
``scripts/train.py`` (the reference's ``train.py``: approximate joint
training, Caffe-order MomentumSGD, lr 1e-3 x0.1 at 50k, 70k iterations).

    python -m trcnn_torch.cli.train --dataset_root /path/VOCdevkit/VOC2007 \
        --pretrained_model imagenet_vgg16.npz --out checkpoints/

    python -m trcnn_torch.cli.train --dataset coco --coco_image_root /path/train2017 \
        --coco_ann_file /path/instances_train2017.json --pretrained_model imagenet_vgg16.npz

Any batch size (padded canvases, one per orientation bucket); checkpoints
``<out>/ckpt_<step>.pt`` with resume; ``--eval_every N`` runs a held-out
VOC07 mAP every N steps and after the last (on COCO's val set with
``--dataset coco``, over its class names).  ``--dataset_root`` repeats for
a union (VOC07+12 trainval).  ``--config`` picks the preset (classes,
canvas, capacities, multi-scale shorter sides) and follows ``--dataset``
by default; ``--dataset synthetic --config coco`` trains the 81-class
recipe on the built-in synthetic set.  COCO training skips crowd boxes.
One device a process: the card unless ``--device cpu``.

Data parallel, one process per device, ``--batch_size`` the global batch
(it must divide by the process count; each process loads its shard):

    torchrun --nproc_per_node 8 -m trcnn_torch.cli.train --distributed ...
    python -m trcnn_torch.cli.train --coordinator HOST:PORT --num_processes N \
        --process_id I ...

``--distributed`` reads the group from the environment (``torchrun``'s
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``);
the three explicit flags name it (``--coordinator`` may also be a
``file://`` URL).  NCCL on the card, gloo with ``--device cpu``.  Only
process 0 logs and writes checkpoints; the evaluator hook shards the
held-out set over the same group.  ``--no_mesh`` trains each process
alone.

With ``--out`` the main process also writes the logged metrics and the
evaluations' scalars (per-class APs included) as TensorBoard summaries
under ``<out>/tb``, when ``tensorboard`` imports; else it says so and logs
to stdout only.  ``--no_writer`` turns that off.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import torch

from trcnn_torch import parallel
from trcnn_torch.cli import DTYPES, add_common_flags, make_config, setup_device
from trcnn_torch.convert_chainer import merge_params
from trcnn_torch.data import (COCODetection, ConcatDetection, DetectionLoader,
                              SyntheticDetection, VOCDetection)
from trcnn_torch.eval import Evaluator
from trcnn_torch.models.faster_rcnn import make_model
from trcnn_torch.train.trainer import TrainConfig, Trainer
from trcnn_torch.weights import import_weights

_OPTIM_FLAGS = {"lr": "base_lr", "lr_decay_step": "lr_decay_step",
                "warmup_steps": "warmup_steps", "clip_grad_norm": "clip_grad_norm"}


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="voc", choices=["voc", "coco", "synthetic"])
    ap.add_argument("--dataset_root", action="append", default=None,
                    help="VOCdevkit/VOCxxxx root (--dataset voc); repeat it to train on the "
                         "union of several")
    ap.add_argument("--split", default="trainval")
    ap.add_argument("--config", default=None, choices=["voc", "coco"],
                    help="hyperparameter preset (classes, canvas, capacities, multi-scale); "
                         "default: matches --dataset (synthetic uses voc)")
    ap.add_argument("--coco_image_root", default=None,
                    help="--dataset coco: directory with the image files (e.g. train2017/)")
    ap.add_argument("--coco_ann_file", default=None,
                    help="--dataset coco: instances_*.json path")
    ap.add_argument("--coco_eval_image_root", default=None,
                    help="--dataset coco: val image dir for --eval_every")
    ap.add_argument("--coco_eval_ann_file", default=None,
                    help="--dataset coco: val instances json for --eval_every")
    ap.add_argument("--out", default="result", help="checkpoint directory")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--iters", type=int, default=None,
                    help="total iterations (default: the config's 70000)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warmup_steps", type=int, default=None,
                    help="linear lr warmup iterations (default 0)")
    ap.add_argument("--clip_grad_norm", type=float, default=None,
                    help="global-norm gradient clip (default 0: off)")
    ap.add_argument("--lr_decay_step", type=int, default=None,
                    help="step from which the lr is multiplied by lr_decay_factor")
    ap.add_argument("--transfer", default="float32", choices=["float32", "uint8"],
                    help="host-to-device image format; uint8 quarters the upload (the "
                         "mean subtraction moves to the device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--checkpoint_every", type=int, default=5000)
    ap.add_argument("--eval_every", type=int, default=0,
                    help="held-out mAP every N steps and after the last (0: off)")
    ap.add_argument("--eval_split", default="test", help="VOC split of the held-out set")
    ap.add_argument("--eval_limit", type=int, default=500,
                    help="evaluate the first N held-out images")
    ap.add_argument("--eval_synthetic_n", type=int, default=256,
                    help="--dataset synthetic: the held-out set's size")
    ap.add_argument("--no_writer", action="store_true",
                    help="no TensorBoard metric writer under <out>/tb (stdout JSON lines only)")
    ap.add_argument("--no_mesh", action="store_true",
                    help="no data parallelism: each process trains alone (debug)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="data parallel: process 0's address (or a file:// URL); with no "
                         "--num_processes/--process_id the environment gives them")
    ap.add_argument("--num_processes", type=int, default=None,
                    help="data parallel: the number of processes")
    ap.add_argument("--process_id", type=int, default=None,
                    help="data parallel: this process's rank")
    ap.add_argument("--distributed", action="store_true",
                    help="data parallel: the group from the environment (torchrun)")
    add_common_flags(ap)
    args = ap.parse_args(argv)
    if args.dataset == "voc" and not args.dataset_root:
        ap.error("--dataset voc requires --dataset_root")
    if args.dataset == "coco" and not (args.coco_image_root and args.coco_ann_file):
        ap.error("--dataset coco requires --coco_image_root and --coco_ann_file")
    if args.dataset == "coco" and args.eval_every and not (
            args.coco_eval_image_root and args.coco_eval_ann_file):
        ap.error("--dataset coco with --eval_every requires --coco_eval_image_root and "
                 "--coco_eval_ann_file")
    return args


class TensorBoardWriter:
    """``write_scalars(step, {name: float})`` onto a
    ``torch.utils.tensorboard.SummaryWriter``."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir)

    def write_scalars(self, step: int, scalars) -> None:
        for name, value in scalars.items():
            self.writer.add_scalar(name, value, step)

    def flush(self) -> None:
        self.writer.flush()


def make_writer(logdir: str) -> Optional[TensorBoardWriter]:
    """A TensorBoard writer under ``logdir``, or None (said on stdout) when
    this machine cannot make one."""
    try:
        return TensorBoardWriter(logdir)
    except Exception as e:         # no tensorboard package, or a broken one
        print(f"[train] metric writer unavailable ({e}); stdout JSON-lines only", flush=True)
        return None


def run(argv: Optional[Sequence[str]] = None) -> Trainer:
    """The CLI's work; returns the trainer after ``fit``."""
    args = parse(argv)
    dtype = DTYPES[args.dtype]
    device = setup_device(args.device, dtype)
    if args.distributed or args.coordinator:
        device = parallel.initialize(args.coordinator, args.num_processes, args.process_id,
                                     backend="gloo" if device.type == "cpu" else "nccl")
    world, rank = parallel.world_size(), parallel.rank()
    if args.batch_size % world:
        raise SystemExit(f"--batch_size {args.batch_size} must divide by the process count "
                         f"{world} (it is the global batch)")
    cfg = make_config(args.backbone,
                      args.config or ("coco" if args.dataset == "coco" else "voc"))
    overrides = {field: getattr(args, flag) for flag, field in _OPTIM_FLAGS.items()
                 if getattr(args, flag) is not None}
    if overrides:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, **overrides))

    if args.dataset == "voc":
        parts = [VOCDetection(root, args.split) for root in args.dataset_root]
        ds = parts[0] if len(parts) == 1 else ConcatDetection(parts)
    elif args.dataset == "coco":
        ds = COCODetection(args.coco_image_root, args.coco_ann_file)
    else:
        ds = SyntheticDetection(n=512, num_classes=cfg.num_classes, seed=args.seed)
    if parallel.is_main_process():
        print(f"dataset: {args.dataset} ({len(ds)} images), device: {device}, "
              f"{world} process(es)", flush=True)
    loader = DetectionLoader(ds, batch_size=args.batch_size // world, image_cfg=cfg.image,
                             augment=True, shuffle=True, repeat=True, seed=args.seed,
                             uint8_images=args.transfer == "uint8", shard_id=rank,
                             num_shards=world)

    model = make_model(cfg, dtype=dtype, device=device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.pretrained_model:
        # strict=False: an ImageNet trunk has no RPN or head; they keep the
        # seeded init
        imported = import_weights(args.pretrained_model, cfg, strict=False)
        model.load_state_dict(merge_params(model.state_dict(), imported))
        if parallel.is_main_process():
            print(f"warm-start: {len(imported)} tensors from {args.pretrained_model}",
                  flush=True)

    writer = None
    if args.out and not args.no_writer and parallel.is_main_process():
        writer = make_writer(f"{args.out}/tb")
    trainer = Trainer(model, cfg, TrainConfig(
        total_iters=args.iters, log_every=args.log_every,
        checkpoint_every=args.checkpoint_every, checkpoint_dir=args.out, seed=args.seed,
        use_mesh=not args.no_mesh, metric_writer=writer, eval_every=args.eval_every),
        device=device)
    if args.eval_every:
        if args.dataset == "voc":
            # the held-out set is the first root's (VOC07 test, also for 07+12)
            eval_ds = VOCDetection(args.dataset_root[0], args.eval_split, use_difficult=True)
        elif args.dataset == "coco":
            eval_ds = COCODetection(args.coco_eval_image_root, args.coco_eval_ann_file,
                                    use_crowd=True)
        else:
            eval_ds = SyntheticDetection(n=args.eval_synthetic_n, num_classes=cfg.num_classes,
                                         seed=args.seed + 1)
        # on the trainer's group: each process evaluates its shard
        trainer.evaluator = Evaluator(model, cfg, eval_ds, limit=args.eval_limit,
                                      batch_size=args.batch_size, device=device,
                                      group=trainer.group)
    trainer.fit(loader)
    if writer is not None:
        writer.flush()
    if parallel.is_main_process():
        print("training done", flush=True)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
