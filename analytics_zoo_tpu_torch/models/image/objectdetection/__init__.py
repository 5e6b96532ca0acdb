"""Object detection — port of ``analytics_zoo_tpu/models/image/
objectdetection``: SSD topologies, priors, MultiBoxLoss, the box
utilities with the batched NMS kernel N1, VOC mAP and ``ObjectDetector``."""

from .bbox import (bbox_iou, decode_boxes, encode_boxes,  # noqa: F401
                   nms_mask, batched_detection_output, detection_output)
from .priors import PriorBox, ssd_priors  # noqa: F401
from .multibox_loss import MultiBoxLoss, match_priors  # noqa: F401
from .ssd import ssd_vgg, ssd_lite  # noqa: F401
from .object_detector import ObjectDetector, DetectionOutputParam  # noqa: F401
from .evaluation import MeanAveragePrecision, average_precision  # noqa: F401
