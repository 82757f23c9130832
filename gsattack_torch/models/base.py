"""Detector protocol, success rule, NMS and IoU: the port of
`gsattack/models/base.py`. A `Detector` exposes a differentiable loss for
the attack and an eval-mode `predict`, plus the shared targeted /
untargeted success rule. Images are (H, W, 3) float [0, 1] channel-last.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


@dataclasses.dataclass
class Detections:
    """Eval-mode detector output (after NMS), host-side numpy."""

    boxes: np.ndarray  # (M, 4) xyxy pixels
    scores: np.ndarray  # (M,)
    classes: np.ndarray  # (M,) int

    def __len__(self):
        return len(self.scores)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 4) x (N, 4) xyxy -> (M, N) IoU."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float = 0.45) -> np.ndarray:
    """Greedy class-agnostic NMS -> kept indices."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = box_iou(boxes[i : i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_thres]
    return np.array(keep, dtype=np.int64)


def evaluate_success(
    dets: Detections,
    gt_bbox: Optional[Sequence[float]],
    target: Optional[int],
    untarget: Optional[int],
    is_targeted: bool,
) -> tuple[bool, dict]:
    """The shared attack-success rule. With a GT box, the prediction of
    best IoU decides: the target exists iff best_iou > 0.5 and its class is
    the target; the untarget is absent unless best_iou > 0.5 and its class
    is the untarget. Without a box: class membership over all predictions.
    Targeted success needs the target (and the untarget absent, if given);
    untargeted success needs the untarget absent."""
    best_class = best_iou = best_idx = closest_confidence = None
    if len(dets) > 0:
        if gt_bbox is not None:
            ious = box_iou(dets.boxes, np.asarray(gt_bbox).reshape(1, 4))[:, 0]
            best_idx = int(np.argmax(ious))
            best_iou = float(ious[best_idx])
            if best_iou > 0.5:
                best_class = int(dets.classes[best_idx])
                closest_confidence = float(dets.scores[best_idx])
            target_pred_exists = best_iou > 0.5 and best_class == target
            untarget_pred_not_exists = not (best_iou > 0.5 and best_class == untarget)
        else:
            classes = dets.classes.tolist()
            target_pred_exists = target in classes
            untarget_pred_not_exists = all(c != untarget for c in classes)
    else:
        target_pred_exists = False
        untarget_pred_not_exists = True

    meets = (
        is_targeted
        and target_pred_exists
        and (untarget is None or untarget_pred_not_exists)
    ) or ((not is_targeted) and untarget_pred_not_exists)
    info = {
        "target_pred_exists": bool(target_pred_exists),
        "untarget_pred_not_exists": bool(untarget_pred_not_exists),
        "best_iou": best_iou,
        "closest_class": best_class,
        "closest_confidence": closest_confidence,
        "closest_idx": best_idx,
    }
    return bool(meets), info


def detections_to_coco(dets: Detections, image_id: int = -1) -> list[dict]:
    """COCO-format detection dicts: xywh boxes rounded to 0.1 px."""
    out = []
    for i in range(len(dets)):
        x1, y1, x2, y2 = (float(v) for v in dets.boxes[i])
        out.append(
            {
                "image_id": image_id,
                "category_id": int(dets.classes[i]),
                "bbox": [round(x1, 1), round(y1, 1), round(x2 - x1, 1), round(y2 - y1, 1)],
                "score": float(dets.scores[i]),
            }
        )
    return out


def image_batch(image, device: torch.device) -> torch.Tensor:
    """One (H, W, 3) image, numpy or tensor, as a (1, H, W, 3) float32
    tensor on `device`."""
    img = image if isinstance(image, torch.Tensor) else torch.as_tensor(np.asarray(image))
    return img.to(device, torch.float32)[None]


def empty_detections() -> Detections:
    return Detections(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int64))


def _to_numpy(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


class Detector:
    """Detector plugin protocol."""

    name: str = "base"

    def load_model(self) -> None:
        """Build or load the weights. Idempotent."""
        raise NotImplementedError

    def loss(self, images: torch.Tensor, target: int, bboxes) -> torch.Tensor:
        """Differentiable scalar loss of (B, H, W, 3) images in [0, 1]
        against (B, 4) xyxy GT boxes in pixels."""
        raise NotImplementedError

    def predict(self, image, threshold: float = 0.5) -> Detections:
        """Eval-mode detection (after NMS)."""
        raise NotImplementedError

    def resolve_label_index(self, name):
        """Class name -> index, or index -> name when given an int
        ("unknown" past the list)."""
        if isinstance(name, (int, np.integer)):
            i = int(name)
            return self.class_names[i] if 0 <= i < len(self.class_names) else "unknown"
        return self.class_names.index(name)

    @property
    def class_names(self) -> list[str]:
        return COCO_CLASSES

    def predict_and_save(
        self,
        image,
        path: Optional[str] = None,
        target: Optional[int] = None,
        untarget: Optional[int] = None,
        is_targeted: bool = True,
        threshold: float = 0.5,
        gt_bbox: Optional[Sequence[float]] = None,
    ) -> bool:
        """Predict, apply the success rule, and save the annotated image
        when `path` is given."""
        dets = self.predict(image, threshold=threshold)
        success, _ = evaluate_success(dets, gt_bbox, target, untarget, is_targeted)
        if path:
            save_detection_image(image, dets, path, self.class_names)
        return success


def save_detection_image(image, dets: Detections, path: str, class_names: list[str]) -> None:
    """Draw boxes and labels on the image and save it."""
    from PIL import Image, ImageDraw

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = (np.clip(_to_numpy(image), 0, 1) * 255).astype(np.uint8)
    im = Image.fromarray(arr)
    draw = ImageDraw.Draw(im)
    for i in range(len(dets)):
        box = [int(v) for v in dets.boxes[i]]
        cls = int(dets.classes[i])
        name = class_names[cls] if 0 <= cls < len(class_names) else str(cls)
        draw.rectangle(box, outline="red", width=3)
        draw.text((box[0], max(box[1] - 12, 0)), f"{name}, {dets.scores[i]:.2f}", fill="white")
    im.save(path)
