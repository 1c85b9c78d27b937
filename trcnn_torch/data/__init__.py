"""Host data layer (port of ``trcnn/data``): preprocessing with the port's
own resize, image files through cv2 or PIL, the VOC, COCO, synthetic and
concatenated datasets, and the batching loader."""

from trcnn_torch.data.coco import COCODetection  # noqa: F401
from trcnn_torch.data.concat import ConcatDetection  # noqa: F401
from trcnn_torch.data.loader import Batch, DetectionLoader, upload  # noqa: F401
from trcnn_torch.data.preprocess import (canvas_shape, compute_scale,  # noqa: F401
                                         preprocess_image, resize_bilinear, scale_gt_boxes)
from trcnn_torch.data.synthetic import SyntheticDetection  # noqa: F401
from trcnn_torch.data.voc import VOCDetection, parse_voc_xml  # noqa: F401
