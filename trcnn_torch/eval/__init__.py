"""Evaluation (port of ``trcnn/eval``): VOC AP, COCO AP and the
single-device evaluator."""

from trcnn_torch.eval.coco_ap import coco_eval  # noqa: F401
from trcnn_torch.eval.evaluator import Evaluator  # noqa: F401
from trcnn_torch.eval.voc_ap import (DetectionRecord, build_records, voc_ap,  # noqa: F401
                                     voc_eval_class, voc_mean_ap, write_voc_detection_files)
