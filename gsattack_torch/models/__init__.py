from .base import COCO_CLASSES, Detections, Detector, box_iou, evaluate_success, nms
from .toy import ToyDetector

__all__ = [
    "COCO_CLASSES",
    "Detections",
    "Detector",
    "ToyDetector",
    "box_iou",
    "evaluate_success",
    "nms",
]
