"""The detector zoo: frozen scoring heads whose loss the attack
differentiates, the port of `gsattack/models`.

`load_detector(name, **kwargs)` builds one by the JAX factory's names and
keyword arguments (`num_classes`, `imgsz`, `seed`, `weights`, ...), plus
`device` (default "cuda").
"""

from .base import (
    COCO_CLASSES,
    Detections,
    Detector,
    box_iou,
    detections_to_coco,
    evaluate_success,
    nms,
)
from .toy import ToyDetector

_REGISTRY = {"toy": ToyDetector}


def register_detector(name):
    """Class decorator: make `load_detector(name, ...)` build it."""

    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def load_detector(name: str, **kwargs) -> Detector:
    """Known names: toy, yolov3, yolov5, yolov8, yolov11 (or a scale key
    such as yolov8s), detectron2, detr."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    from .yolo_blocks import SCALES, SPECS

    if name in SPECS or name in SCALES:
        from .yolo import YoloDetector

        return YoloDetector(variant=name, **kwargs)
    if name == "detectron2":
        from .frcnn import FasterRCNNDetector

        return FasterRCNNDetector(**kwargs)
    if name == "detr":
        from .detr import DetrDetector

        return DetrDetector(**kwargs)
    raise ValueError(f"Unknown detector: {name}")


__all__ = [
    "COCO_CLASSES",
    "Detections",
    "Detector",
    "ToyDetector",
    "box_iou",
    "detections_to_coco",
    "evaluate_success",
    "nms",
    "load_detector",
    "register_detector",
]
