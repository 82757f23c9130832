"""The YOLO detector family (v3u / v5u / v8 / v11), the port of
`gsattack/models/yolo.py`.

  * graph: `yolo_blocks.YoloGraph`, one per variant and scale;
  * loss: the v8 detection loss, batched over the views: task-aligned
    assignment (top 10, alpha 0.5, beta 6) on detached scores and boxes,
    BCE to the aligned soft targets, CIoU and distribution-focal loss on
    the assigned anchors, gains box 7.5, cls 0.5, dfl 1.5;
  * input: a differentiable letterbox to `imgsz` (antialiased bilinear
    resize, as `jax.image.resize` does, and grey padding);
  * eval: sigmoid scores, DFL expectation decode, class-agnostic NMS.

Images are (B, H, W, 3) in [0, 1] at the public API; the graph runs NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import COCO_CLASSES, Detections, Detector, empty_detections, image_batch, nms
from .layers import freeze, init_dense
from .yolo_blocks import REG_MAX, STRIDES, YoloGraph, resolve_variant


def make_anchors(hw_list: Sequence[tuple[int, int]], strides=STRIDES, device=None):
    """Cell-centre anchor points (A, 2) in pixels and each one's stride
    (A,), level by level, row-major within a level."""
    pts, strs = [], []
    for (h, w), s in zip(hw_list, strides):
        ys = (torch.arange(h, device=device) + 0.5) * s
        xs = (torch.arange(w, device=device) + 0.5) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strs.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl_expectation(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4, REG_MAX) logits -> (..., 4) expected distances in bins."""
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_logits.device)
    return (torch.softmax(box_logits, dim=-1) * bins).sum(-1)


def decode_boxes(box_logits, anchors, strides_arr):
    """DFL logits (..., A, 4 * REG_MAX) and anchors (A, 2) -> xyxy boxes
    (..., A, 4) in pixels."""
    d = dfl_expectation(box_logits.reshape(*box_logits.shape[:-1], 4, REG_MAX))
    d = d * strides_arr[:, None]
    return torch.cat([anchors - d[..., :2], anchors + d[..., 2:]], dim=-1)


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of aligned xyxy boxes (..., 4); the aspect term's
    weight alpha passes no gradient."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    w1 = box1[..., 2] - box1[..., 0]
    h1 = box1[..., 3] - box1[..., 1]
    w2 = box2[..., 2] - box2[..., 0]
    h2 = box2[..., 3] - box2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(box1[..., 2], box2[..., 2]) - torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) - torch.minimum(box1[..., 1], box2[..., 1])
    c2 = cw * cw + ch * ch + eps
    rho2 = (
        (box2[..., 0] + box2[..., 2] - box1[..., 0] - box1[..., 2]) ** 2
        + (box2[..., 1] + box2[..., 3] - box1[..., 1] - box1[..., 3]) ** 2
    ) / 4.0
    v = (4 / np.pi**2) * (
        torch.atan(w2 / h2.clamp(min=eps)) - torch.atan(w1 / h1.clamp(min=eps))
    ) ** 2
    alpha = (v / (1 - iou + v).clamp(min=eps)).detach()
    return iou - rho2 / c2 - alpha * v


def pairwise_iou_xyxy(a, b, eps=1e-7):
    """(..., M, 4) x (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=eps)


@torch.no_grad()
def task_aligned_assign(
    cls_scores,  # (B, A, nc) sigmoid scores
    pred_boxes,  # (B, A, 4) decoded xyxy
    anchors,  # (A, 2)
    gt_boxes,  # (B, M, 4) xyxy, padded
    gt_labels,  # (B, M) int
    gt_valid,  # (B, M) bool
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
):
    """Ultralytics TaskAlignedAssigner semantics over padded GTs, batched.
    An anchor is a GT's candidate when its centre lies strictly inside the
    box; it is taken when its metric is at least the GT's k-th largest (so
    every anchor tied with the k-th is taken); an anchor taken by several
    GTs goes to the one of largest metric (the first on a tie).

    Returns fg (B, A), target labels (B, A), target boxes (B, A, 4) and
    soft target scores (B, A, nc)."""
    nc = cls_scores.shape[-1]
    a = anchors.shape[0]
    ax, ay = anchors[:, 0], anchors[:, 1]
    inside = (
        (ax > gt_boxes[..., 0, None]) & (ax < gt_boxes[..., 2, None])
        & (ay > gt_boxes[..., 1, None]) & (ay < gt_boxes[..., 3, None])
    ) & gt_valid[..., None]  # (B, M, A)
    ious = pairwise_iou_xyxy(gt_boxes, pred_boxes)  # (B, M, A)
    labels = gt_labels.long().clamp(0, nc - 1)
    cls_for_gt = torch.gather(cls_scores.transpose(1, 2), 1,
                              labels[..., None].expand(-1, -1, a))  # (B, M, A)
    metric = cls_for_gt**alpha * ious.clamp(min=0) ** beta
    metric = torch.where(inside, metric, 0.0)
    thresh = torch.topk(metric, min(topk, a), dim=-1).values[..., -1:]  # k-th largest
    is_topk = (metric >= thresh.clamp(min=1e-12)) & (metric > 0)
    best_gt = torch.where(is_topk, metric, -1.0).argmax(dim=1)  # (B, A)
    fg = is_topk.any(dim=1)
    tl = torch.gather(gt_labels.long(), 1, best_gt)
    tb = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    t_metric = torch.where(is_topk, metric, 0.0).amax(dim=1)
    per_gt_max_metric = metric.amax(dim=2)  # (B, M)
    per_gt_max_iou = torch.where(is_topk, ious, 0.0).amax(dim=2)
    norm = (t_metric * torch.gather(per_gt_max_iou, 1, best_gt)
            / torch.gather(per_gt_max_metric, 1, best_gt).clamp(min=1e-9))
    scores = F.one_hot(tl.clamp(0, nc - 1), nc).to(cls_scores.dtype)
    scores = scores * torch.where(fg, norm, 0.0)[..., None]
    return fg, tl, tb, scores


def v8_detection_loss(
    head_outs,  # per scale (B, 4R + nc, H, W)
    gt_boxes,  # (B, M, 4) xyxy pixels
    gt_labels,  # (B, M)
    gt_valid,  # (B, M)
    nc: int,
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
):
    """The v8 training loss, summed over the views."""
    hw = [(o.shape[2], o.shape[3]) for o in head_outs]
    anchors, strides_arr = make_anchors(hw, device=head_outs[0].device)
    flat = torch.cat([o.flatten(2).transpose(1, 2) for o in head_outs], dim=1)  # (B, A, C)
    bl = flat[..., : 4 * REG_MAX]
    cl = flat[..., 4 * REG_MAX:]
    b, a = cl.shape[:2]
    pboxes = decode_boxes(bl, anchors, strides_arr)
    fg, _, tb, ts = task_aligned_assign(torch.sigmoid(cl).detach(), pboxes.detach(), anchors,
                                        gt_boxes, gt_labels, gt_valid)
    tss = ts.sum(dim=(1, 2)).clamp(min=1.0)
    bce = cl.clamp(min=0) - cl * ts + torch.log1p(torch.exp(-cl.abs()))
    loss_cls = bce.sum(dim=(1, 2)) / tss
    weight = ts.sum(-1)
    c = ciou(pboxes, tb)
    loss_box = torch.where(fg, (1.0 - c) * weight, 0.0).sum(1) / tss
    t_ltrb = torch.cat([(anchors - tb[..., :2]) / strides_arr[:, None],
                        (tb[..., 2:] - anchors) / strides_arr[:, None]], dim=-1)
    t_ltrb = t_ltrb.clamp(0, REG_MAX - 1 - 0.01)
    tl_low = torch.floor(t_ltrb)
    wl = tl_low + 1.0 - t_ltrb
    wr = 1.0 - wl
    logp = F.log_softmax(bl.reshape(b, a, 4, REG_MAX), dim=-1)
    il = tl_low.long()[..., None]
    lp_l = torch.gather(logp, -1, il)[..., 0]
    lp_r = torch.gather(logp, -1, (il + 1).clamp(0, REG_MAX - 1))[..., 0]
    dfl = (-(wl * lp_l + wr * lp_r)).mean(-1)
    loss_dfl = torch.where(fg, dfl * weight, 0.0).sum(1) / tss
    return (loss_box * box_gain + loss_cls * cls_gain + loss_dfl * dfl_gain).sum()


def letterbox(images: torch.Tensor, size: int = 640, pad_value: float = 114 / 255):
    """Differentiable letterbox of (B, 3, H, W) images: aspect-preserving
    bilinear resize (antialiased when it shrinks, as `jax.image.resize`)
    and centred grey padding to size x size. Returns (images, scale,
    (pad_x, pad_y))."""
    h, w = images.shape[2:]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        images = F.interpolate(images, size=(nh, nw), mode="bilinear", align_corners=False,
                               antialias=True)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    out = F.pad(images, (pad_x, size - nw - pad_x, pad_y, size - nh - pad_y), value=pad_value)
    return out, scale, (pad_x, pad_y)


class YoloDetector(nn.Module, Detector):
    """Frozen YOLO scoring head: `variant` is a family (yolov3, yolov5,
    yolov8, yolov11) or a scale key (yolov8s, ...)."""

    def __init__(
        self,
        variant: str = "yolov8",
        num_classes: int = 80,
        imgsz: int = 640,
        seed: int = 0,
        weights: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        family, key = resolve_variant(variant)
        dev = resolve_device(device)
        self.name = variant
        self.family = family
        self.variant = key
        self.nc = num_classes
        self.imgsz = imgsz
        self.seed = seed
        self.model = YoloGraph(family, key, num_classes)
        init_dense(self.model, torch.Generator().manual_seed(seed))
        self._bias_init()
        if weights:
            from .convert_yolo import load_into

            load_into(self.model, weights)
        freeze(self, dev)

    @property
    def device(self) -> torch.device:
        return self.model.model[0].conv.weight.device

    @property
    def class_names(self):
        return COCO_CLASSES[: self.nc]

    def load_model(self) -> None:
        """The weights are made (or loaded) in the constructor."""

    def _bias_init(self) -> None:
        """ultralytics Detect.bias_init: the box branch's last bias 1, the
        class branch's log(5 / nc / (640 / stride)^2), so that a fresh head
        gives calibrated priors, and usable attack gradients, rather than
        flat noise."""
        det = self.model.model[-1]
        with torch.no_grad():
            for i, s in enumerate(STRIDES):
                det.cv2[i][2].bias.fill_(1.0)
                det.cv3[i][2].bias.fill_(float(np.log(5.0 / self.nc / (640.0 / s) ** 2)))

    def forward(self, images: torch.Tensor):
        """(B, H, W, 3) in [0, 1] -> (letterboxed head maps, scale, pad)."""
        img, scale, pad = letterbox(images.permute(0, 3, 1, 2), self.imgsz)
        return self.model(img), scale, pad

    def loss(self, images, target, bboxes):
        """The v8 training loss with every GT box labelled `target`."""
        images = images if images.ndim == 4 else images[None]
        b = images.shape[0]
        bboxes = torch.as_tensor(np.asarray(bboxes, np.float32), device=images.device)
        bboxes = bboxes.reshape(b, -1, 4)
        outs, scale, (px, py) = self(images)
        gb = bboxes * scale + torch.tensor([px, py, px, py], dtype=torch.float32,
                                           device=images.device)
        gl = torch.full(gb.shape[:2], int(target), dtype=torch.long, device=images.device)
        gv = (bboxes != 0).any(-1) | ((bboxes[..., 2] > bboxes[..., 0])
                                      & (bboxes[..., 3] > bboxes[..., 1]))
        return v8_detection_loss(outs, gb, gl, gv, self.nc)

    @torch.no_grad()
    def predict(self, image, threshold: float = 0.5) -> Detections:
        images = image_batch(image, self.device)
        h0, w0 = images.shape[1:3]
        outs, scale, (px, py) = self(images)
        anchors, strides_arr = make_anchors([o.shape[2:] for o in outs], device=images.device)
        flat = torch.cat([o.flatten(2).transpose(1, 2) for o in outs], dim=1)[0]
        boxes = decode_boxes(flat[:, : 4 * REG_MAX], anchors, strides_arr)
        conf, best = torch.sigmoid(flat[:, 4 * REG_MAX:]).max(dim=-1)
        keep_mask = (conf > threshold).cpu().numpy()
        if not keep_mask.any():
            return empty_detections()
        b = boxes.cpu().numpy()[keep_mask]
        b = (b - np.array([px, py, px, py])) / scale
        b[:, 0::2] = b[:, 0::2].clip(0, w0)
        b[:, 1::2] = b[:, 1::2].clip(0, h0)
        s = conf.cpu().numpy()[keep_mask]
        c = best.cpu().numpy()[keep_mask].astype(np.int64)
        keep = nms(b, s, iou_thres=0.45)
        return Detections(b[keep], s[keep], c[keep])
