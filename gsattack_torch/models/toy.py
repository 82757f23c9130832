"""Toy grid detector, the port of `gsattack/models/toy.py`: three strided
3x3 convolutions with ReLU, then a 1x1 head giving per-cell objectness and
class logits over a grid of stride 8. The loss is BCE objectness plus
cross-entropy of the target class on the cells whose centre lies in the GT
box; `predict` merges each confident class's cells into one box.

The convolutions run as NCHW `F.conv2d`; the public `loss` and `predict`
keep the reference's channel-last (B, H, W, 3) images, and the padding is
XLA's "SAME" (the extra row/column on the high side when odd).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import COCO_CLASSES, Detections, Detector, empty_detections, image_batch, nms

STRIDE = 8


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """conv2d with XLA's "SAME" padding (NCHW input, OIHW weights)."""
    pads = []
    for size, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, b, stride=stride)


class ToyDetector(nn.Module, Detector):
    name = "toy"

    def __init__(
        self,
        num_classes: int = 80,
        seed: int = 0,
        channels: int = 16,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.num_classes = num_classes
        self.seed = seed
        self.channels = channels
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        c = channels
        params = {}
        for i, (cin, cout) in enumerate(((3, c), (c, c), (c, c))):
            w = torch.randn((cout, cin, 3, 3), generator=gen) / np.sqrt(9 * cin)
            params[f"w{i}"] = w
            params[f"b{i}"] = torch.zeros(cout)
        params["wh"] = torch.randn((1 + num_classes, c, 1, 1), generator=gen) * 0.3
        params["bh"] = torch.zeros(1 + num_classes)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev), requires_grad=False) for k, v in params.items()}
        )

    @property
    def class_names(self):
        return COCO_CLASSES[: self.num_classes]

    def load_model(self) -> None:
        """The weights are made in the constructor; nothing to load."""

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> head (B, H/8, W/8, 1 + num_classes)."""
        x = images.permute(0, 3, 1, 2)
        p = self.params
        for i in range(3):
            x = F.relu(_conv_same(x, p[f"w{i}"], p[f"b{i}"], 2))
        head = F.conv2d(x, p["wh"], p["bh"])
        return head.permute(0, 2, 3, 1)

    def _cell_targets(self, hc: int, wc: int, bbox: torch.Tensor) -> torch.Tensor:
        """(Hc, Wc) float positives: cells whose centre lies in the box."""
        dev = bbox.device
        cy = (torch.arange(hc, device=dev, dtype=torch.float32) + 0.5) * STRIDE
        cx = (torch.arange(wc, device=dev, dtype=torch.float32) + 0.5) * STRIDE
        inside_y = (cy >= bbox[1]) & (cy < bbox[3])
        inside_x = (cx >= bbox[0]) & (cx < bbox[2])
        return (inside_y[:, None] & inside_x[None, :]).to(torch.float32)

    def loss(self, images: torch.Tensor, target: int, bboxes) -> torch.Tensor:
        head = self(images)
        obj_logit = head[..., 0]
        cls_logit = head[..., 1:]
        bboxes = torch.as_tensor(
            np.asarray(bboxes, np.float32), device=images.device
        ).reshape(-1, 4)
        _, hc, wc = obj_logit.shape
        pos = torch.stack([self._cell_targets(hc, wc, b) for b in bboxes])
        zero = torch.zeros_like(obj_logit)
        obj_bce = (
            torch.maximum(obj_logit, zero)
            - obj_logit * pos
            + torch.log1p(torch.exp(-torch.abs(obj_logit)))
        ).mean(dim=(1, 2))
        logp = F.log_softmax(cls_logit, dim=-1)
        ce = -(logp[..., int(target)] * pos).sum(dim=(1, 2)) / torch.clamp(
            pos.sum(dim=(1, 2)), min=1.0
        )
        return (obj_bce + ce).mean()

    @torch.no_grad()
    def predict(self, image, threshold: float = 0.5) -> Detections:
        """One merged box per confident class: the bounding box over that
        class's confident cells."""
        head = self(image_batch(image, self.params["w0"].device))
        obj = torch.sigmoid(head[0, ..., 0])
        cls_prob = torch.softmax(head[0, ..., 1:], dim=-1)
        score_map = (obj[..., None] * cls_prob).cpu().numpy()
        best_cls = np.argmax(score_map, axis=-1)
        best_score = np.max(score_map, axis=-1)
        confident = best_score > threshold
        boxes, scores, classes = [], [], []
        for c in np.unique(best_cls[confident]):
            ys, xs = np.nonzero(confident & (best_cls == c))
            boxes.append(
                [xs.min() * STRIDE, ys.min() * STRIDE, (xs.max() + 1) * STRIDE,
                 (ys.max() + 1) * STRIDE]
            )
            scores.append(float(best_score[ys, xs].max()))
            classes.append(int(c))
        if not boxes:
            return empty_detections()
        boxes = np.asarray(boxes, np.float32)
        scores = np.asarray(scores, np.float32)
        classes = np.asarray(classes, np.int64)
        keep = nms(boxes, scores)
        return Detections(boxes[keep], scores[keep], classes[keep])
