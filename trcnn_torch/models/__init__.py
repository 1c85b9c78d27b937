"""Model graph of the port: VGG-16 trunk, RPN head, RoI head, losses,
Faster R-CNN."""

from trcnn_torch.models.faster_rcnn import (  # noqa: F401
    Detections, FasterRCNN, RawDetections, cast_params_for_inference, make_model,
    postprocess)
