"""Detection evaluator, on one device or sharded over a process group
(port of ``trcnn/eval/evaluator.py``).

``Evaluator(model, cfg, dataset)(model)`` runs batched inference over the
dataset (or its first ``limit`` images) on ``device`` (the card unless the
caller asks for the CPU): the loader's canvases are uploaded from pinned
memory, one ``detect`` and one ``postprocess`` run per batch without
autograd, and the padded duplicates of a partial final batch are dropped.
Ground truth comes from the annotations alone (no second image decode).
It returns JAX's keys: ``eval_mAP`` and ``eval_AP/<class>`` (VOC), or
``eval_AP``, ``eval_AP50`` and ``eval_AP75`` (COCO), then ``eval_seconds``
and ``eval_images``.

Given a process group of more than one rank (the JAX evaluator's
multi-host branch), each rank decodes and detects only its loader shard at
``batch_size // world`` images a batch; the per-image detections, keyed by
image id, are gathered on the host over gloo and merged in rank order,
each image once (a partial global batch repeats images into other shards),
so that every rank scores the whole set and returns the same numbers.
``eval_images`` counts the set; ``last_local_images`` the images this rank
detected.  Over a (data, model) grid the group is the trainer's data group:
the model ranks of one data index detect the same images, each with
fc6/fc7 gathered whole over its model group for the pass (JAX's
``make_detect_step`` takes the parameters replicated).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from trcnn_torch import parallel
from trcnn_torch.config import VOC_CLASSES, FasterRCNNConfig
from trcnn_torch.data.loader import DetectionLoader, upload
from trcnn_torch.eval.coco_ap import coco_eval
from trcnn_torch.eval.voc_ap import build_records, voc_mean_ap
from trcnn_torch.models.faster_rcnn import FasterRCNN, postprocess
from trcnn_torch.parallel.tensor import whole_head

METRICS = ("voc07", "voc", "coco")


class _Subset:
    """The first n examples of a dataset (a finite loader for a limited
    evaluation)."""

    def __init__(self, dataset, n: int):
        self._ds = dataset
        self._n = min(n, len(dataset))

    def __len__(self) -> int:
        return self._n

    def get_example(self, i):
        return self._ds.get_example(i)

    def get_annotation(self, i):
        return self._ds.get_annotation(i)

    def get_size(self, i):
        return self._ds.get_size(i)

    __getitem__ = get_example


class Evaluator:
    """Callable ``evaluator(model) -> {"eval_mAP": ..., ...}``.

    class_names: every class, background first (default: the dataset's
    ``class_names``, else VOC's).  metric: "voc07" (11-point), "voc"
    (area under the curve) or "coco" (AP@[.5:.95], crowd regions ignored).  After each call, ``detections`` holds
    :meth:`collect_detections`'s list and ``timing`` the seconds of the
    detection pass, of them those spent waiting on the loader and in
    detection (upload, detect, postprocess, the results back on the host),
    the number of batches per canvas shape, and the number of images this
    rank detected.  ``group``: the process group to shard over (the
    trainer's data group); None or a group of one rank evaluates in this
    process.
    """

    def __init__(self, model: FasterRCNN, cfg: FasterRCNNConfig, dataset, class_names=None,
                 batch_size: int = 8, limit: Optional[int] = None, metric: str = "voc07",
                 score_thresh: Optional[float] = None, device="cuda", group=None):
        if metric not in METRICS:
            raise ValueError(f"metric {metric!r}: the port evaluates {METRICS}")
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.class_names = tuple(class_names or getattr(dataset, "class_names", VOC_CLASSES))
        self.metric = metric
        self.score_thresh = score_thresh
        self.limit = min(limit, len(dataset)) if limit else len(dataset)
        if self.limit < len(dataset):
            dataset = _Subset(dataset, self.limit)
        self.dataset = dataset
        rank, world = parallel.shard_of(group)
        self.group = group if world > 1 else None
        self.loader = DetectionLoader(dataset, batch_size=max(batch_size // world, 1),
                                      image_cfg=cfg.image, shard_id=rank, num_shards=world)
        self._annotations: Optional[Dict[str, dict]] = None
        self.detections: List[dict] = []
        self.timing: Dict = {}
        self.last_local_images = 0

    def annotations(self) -> Dict[str, dict]:
        """{id: {"boxes", "labels", "difficult", "crowd"}}, parsed once."""
        if self._annotations is None:
            anns = {}
            for idx in range(self.limit):
                ex = self.dataset.get_annotation(idx)
                diff = np.asarray(ex.get("difficult", np.zeros(len(ex["labels"]), bool)))
                anns[ex["id"]] = {"boxes": ex["boxes"], "labels": ex["labels"],
                                  "difficult": diff, "crowd": diff}
            self._annotations = anns
        return self._annotations

    def collect_detections(self, model: Optional[FasterRCNN] = None) -> List[dict]:
        """Inference over the dataset -> [{"id", "boxes" (D, 4) in original
        image coordinates, "scores" (D,), "classes" (D,)}], one per image:
        over the group, this rank's shard detected and every rank's
        gathered."""
        model = self.model if model is None else model
        was_training = model.training
        model.eval()
        detections: List[dict] = []
        seen = set()
        start = time.perf_counter()
        wait = detect = 0.0
        shapes: Dict[tuple, int] = {}
        try:
            with whole_head(model), torch.inference_mode():
                it = iter(self.loader)
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    t1 = time.perf_counter()
                    wait += t1 - t0
                    if batch is None:
                        break
                    shape = batch.images.shape[1:3]
                    shapes[shape] = shapes.get(shape, 0) + 1
                    images = upload(batch.images, self.device)
                    im_info = upload(batch.im_info, self.device)
                    dets = postprocess(model.detect(images, im_info), im_info, self.cfg,
                                       score_thresh=self.score_thresh)
                    boxes, scores, classes, valid = (t.cpu().numpy() for t in dets)
                    detect += time.perf_counter() - t1
                    for i, iid in enumerate(batch.ids):
                        if iid in seen:
                            continue           # a partial batch's padded duplicate
                        seen.add(iid)
                        v = valid[i]
                        detections.append({"id": iid, "boxes": boxes[i, v],
                                           "scores": scores[i, v], "classes": classes[i, v]})
        finally:
            model.train(was_training)
        self.timing = {"wall_s": time.perf_counter() - start, "wait_s": wait,
                       "detect_s": detect, "batches": shapes, "images": len(detections)}
        self.last_local_images = len(detections)
        if self.group is None:
            return detections
        return self._merge(detections)

    def _merge(self, local: List[dict]) -> List[dict]:
        """Every rank's detections, gathered on the host and merged in rank
        order, each dataset image once."""
        merged, seen = [], set()
        for shard in parallel.host_gather(local, self.group):
            for d in shard:
                if d["id"] not in seen:       # an image repeated into another shard
                    seen.add(d["id"])
                    merged.append(d)
        return merged

    def __call__(self, model: Optional[FasterRCNN] = None) -> Dict[str, float]:
        t0 = time.time()
        self.detections = detections = self.collect_detections(model)
        if self.metric == "coco":
            res = coco_eval(detections, self.annotations(), len(self.class_names))
            out = {"eval_AP": res["AP"], "eval_AP50": res["AP50"], "eval_AP75": res["AP75"]}
        else:
            records = build_records(self.class_names, detections, self.annotations())
            mean_ap, aps = voc_mean_ap(records, use_07_metric=self.metric == "voc07")
            out = {"eval_mAP": mean_ap}
            out.update({f"eval_AP/{k}": v for k, v in aps.items()})
        out["eval_seconds"] = time.time() - t0
        out["eval_images"] = float(len(detections))
        return out
