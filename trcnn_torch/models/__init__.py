"""Model graph of the port: VGG-16 and ResNet-101-C4 trunks, RPN head, RoI
heads, losses, Faster R-CNN."""

from trcnn_torch.models.faster_rcnn import (  # noqa: F401
    Detections, FasterRCNN, RawDetections, cast_params_for_inference, make_model,
    postprocess)
