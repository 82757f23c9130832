"""The plain reference detector: Faster R-CNN R50-FPN as detectron2's
COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml builds it (caffe bottlenecks
3-4-6-3, FPN 256, RPN with 3 aspects, a 2-fc box head, 80 classes), with
the attack loss the benchmark's DAGGER cell differentiates: the ROI head's
softmax cross-entropy on a deterministic ROI batch (the GT box appended,
IoU >= 0.5 labelled `target`, else background), proposals from a stable
top-k of RPN objectness per level and overall, aligned ROIAlign with 2 x 2
samples a bin.

A frozen copy of the program's plain detector code, kept here so that the
reference stays what it is when the program changes; it imports nothing of
the program. Its state-dict keys are detectron2's, which the harness uses
to hand one set of weights to both sides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """Batch norm on stored statistics: (x - mean) / sqrt(var + eps) *
    weight + bias per channel of an NCHW tensor. Its state entries are the
    upstream norms' `weight`, `bias`, `running_mean` and `running_var`
    (buffers: nothing here trains)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


def pairwise_iou_xyxy(a, b, eps=1e-7):
    """(..., M, 4) x (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=eps)


PIXEL_MEAN = (103.530, 116.280, 123.675)  # BGR
PIXEL_STD = (1.0, 1.0, 1.0)
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # per FPN level P2..P6
ASPECTS = (0.5, 1.0, 2.0)
FPN_CH = 256
POOL = 7
ROI_BATCH = 512
ROI_POS_FRACTION = 0.25


class D2Conv(nn.Conv2d):
    """detectron2 Conv2d with a child norm: `convN.weight`,
    `convN.norm.*`. No bias, padding k // 2."""

    def __init__(self, cin: int, cout: int, k: int = 3, s: int = 1):
        super().__init__(cin, cout, k, s, k // 2, bias=False)
        self.norm = FrozenBN(cout, eps=1e-5)

    def forward(self, x):
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    """Caffe-style bottleneck: the stride in conv1 (stride_in_1x1)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, shortcut: bool = False):
        super().__init__()
        mid = cout // 4
        self.conv1 = D2Conv(cin, mid, 1, stride)
        self.conv2 = D2Conv(mid, mid, 3, 1)
        self.conv3 = D2Conv(mid, cout, 1, 1)
        self.shortcut = D2Conv(cin, cout, 1, stride) if shortcut else None

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = self.conv3(h)
        s = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(s + h)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = D2Conv(3, 64, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


class BottomUp(nn.Module):
    """ResNet-50: stem, then res2..res5 of 3, 4, 6, 3 blocks."""

    def __init__(self):
        super().__init__()
        self.stem = Stem()
        cin = 64
        for si, (blocks, ch) in enumerate([(3, 256), (4, 512), (6, 1024), (3, 2048)]):
            stride = 1 if si == 0 else 2
            mods = [BottleneckBlock(cin, ch, stride, shortcut=True)]
            mods += [BottleneckBlock(ch, ch) for _ in range(blocks - 1)]
            setattr(self, f"res{si + 2}", nn.Sequential(*mods))
            cin = ch

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for stage in (self.res2, self.res3, self.res4, self.res5):
            x = stage(x)
            outs.append(x)
        return outs  # C2..C5 at strides 4, 8, 16, 32


class FPNBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.bottom_up = BottomUp()
        for i, cin in enumerate((256, 512, 1024, 2048)):
            setattr(self, f"fpn_lateral{i + 2}", nn.Conv2d(cin, FPN_CH, 1))
            setattr(self, f"fpn_output{i + 2}", nn.Conv2d(FPN_CH, FPN_CH, 3, 1, 1))

    def forward(self, x):
        lats = [getattr(self, f"fpn_lateral{i + 2}")(c) for i, c in enumerate(self.bottom_up(x))]
        tops = [lats[3]]
        for lat in lats[2::-1]:
            # `jax.image.resize`'s nearest: source floor((i + 0.5) * in / out).
            up = F.interpolate(tops[0], size=lat.shape[2:], mode="nearest-exact")
            tops.insert(0, lat + up)
        outs = [getattr(self, f"fpn_output{i + 2}")(t) for i, t in enumerate(tops)]
        return outs + [outs[-1][:, :, ::2, ::2]]  # P2..P6 at strides 4..64


class RPNHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(FPN_CH, FPN_CH, 3, 1, 1)
        self.objectness_logits = nn.Conv2d(FPN_CH, len(ASPECTS), 1)
        self.anchor_deltas = nn.Conv2d(FPN_CH, len(ASPECTS) * 4, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            h = F.relu(self.conv(f))
            outs.append((self.objectness_logits(h), self.anchor_deltas(h)))
        return outs


class ProposalGenerator(nn.Module):
    def __init__(self):
        super().__init__()
        self.rpn_head = RPNHead()


class BoxHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(FPN_CH * POOL * POOL, 1024)
        self.fc2 = nn.Linear(1024, 1024)

    def forward(self, roi_feats):  # (R, C, POOL, POOL), flattened channel-first
        return F.relu(self.fc2(F.relu(self.fc1(roi_feats.flatten(1)))))


class BoxPredictor(nn.Module):
    def __init__(self, nc: int):
        super().__init__()
        self.cls_score = nn.Linear(1024, nc + 1)
        self.bbox_pred = nn.Linear(1024, nc * 4)

    def forward(self, h):
        return self.cls_score(h), self.bbox_pred(h)


class ROIHeads(nn.Module):
    def __init__(self, nc: int):
        super().__init__()
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor(nc)

    def forward(self, roi_feats):
        return self.box_predictor(self.box_head(roi_feats))


class D2FasterRCNN(nn.Module):
    """GeneralizedRCNN's module tree. `forward` gives the FPN levels and
    the RPN outputs; `roi_heads` takes pooled ROI features."""

    def __init__(self, nc: int = 80):
        super().__init__()
        self.backbone = FPNBackbone()
        self.proposal_generator = ProposalGenerator()
        self.roi_heads = ROIHeads(nc)

    def forward(self, images):
        fpn = self.backbone(images)
        return fpn, self.proposal_generator.rpn_head(fpn)


def make_level_anchors(h: int, w: int, stride: int, size: float, device=None):
    """(H * W * A, 4) xyxy anchors, cell-major then aspect."""
    ys = (torch.arange(h, device=device) + 0.5) * stride
    xs = (torch.arange(w, device=device) + 0.5) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
    boxes = []
    for a in ASPECTS:
        half = torch.tensor([size * np.sqrt(1.0 / a) / 2, size * np.sqrt(a) / 2],
                            dtype=torch.float32, device=device)
        boxes.append(torch.cat([centers - half, centers + half], dim=-1))
    return torch.stack(boxes, dim=1).reshape(-1, 4)


def decode_deltas(anchors, deltas):
    """The R-CNN box parameterisation, over (..., 4) boxes and deltas."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    cxa = anchors[..., 0] + wa / 2
    cya = anchors[..., 1] + ha / 2
    cx = cxa + deltas[..., 0] * wa
    cy = cya + deltas[..., 1] * ha
    w = wa * torch.exp(deltas[..., 2].clamp(-4, 4))
    h = ha * torch.exp(deltas[..., 3].clamp(-4, 4))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def roi_align(feat, boxes, stride: int, pool: int = POOL, sampling: int = 2):
    """ROIAlign, aligned (half-pixel shift), `sampling`^2 bilinear samples
    per bin averaged, sample coordinates clamped to the map:
    (B, C, H, W) features and (B, R, 4) pixel boxes -> (B, R, C, pool,
    pool)."""
    level = torch.zeros(boxes.shape[:2], dtype=torch.long, device=boxes.device)
    return roi_align_levels([feat], boxes, level, (stride,), pool, sampling)


def roi_align_levels(feats, boxes, level, strides, pool: int = POOL, sampling: int = 2):
    """`roi_align` of each (B, R, 4) box on its own map, `feats[level]`
    (stride `strides[level]`): one pass over the boxes, whatever their
    levels. -> (B, R, C, pool, pool)."""
    dev = boxes.device
    b, c = feats[0].shape[:2]
    r = boxes.shape[1]
    hs = torch.tensor([f.shape[2] for f in feats], device=dev)[level]  # (B, R)
    ws = torch.tensor([f.shape[3] for f in feats], device=dev)[level]
    sizes = [f.shape[2] * f.shape[3] for f in feats]
    offs = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)[level]
    stride = torch.tensor(strides, dtype=torch.float32, device=dev)[level]
    x1, y1, x2, y2 = (boxes / stride[..., None]).unbind(-1)  # (B, R)
    j = torch.arange(pool, dtype=torch.float32, device=dev)[:, None]
    k = torch.arange(sampling, dtype=torch.float32, device=dev)[None, :]
    off = (j + (k + 0.5) / sampling).reshape(-1)  # (P,), P = pool * sampling
    xg = x1[..., None] + off * ((x2 - x1) / pool)[..., None] - 0.5  # (B, R, P)
    yg = y1[..., None] + off * ((y2 - y1) / pool)[..., None] - 0.5
    w_last, h_last = (ws - 1)[..., None], (hs - 1)[..., None]
    x0 = torch.minimum(torch.floor(xg).clamp(min=0), w_last.to(xg.dtype))
    y0 = torch.minimum(torch.floor(yg).clamp(min=0), h_last.to(yg.dtype))
    wx = (xg - x0).clamp(0.0, 1.0)[:, :, None, :, None]  # (B, R, 1, P, 1)
    wy = (yg - y0).clamp(0.0, 1.0)[:, :, :, None, None]  # (B, R, P, 1, 1)
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = torch.minimum(x0i + 1, w_last), torch.minimum(y0i + 1, h_last)
    # Rows of the levels' (B * sum(H * W), C) table by `index_select`, whose
    # backward is an `index_add_` of atomic adds. Advanced indexing's
    # backward sorts the indices, and at the main path's shapes (4 views of
    # 800x800, 257 ROIs) it took 25 ms a call on an H100 (`chip_smoke.py`
    # phase 6's profile).
    rows = torch.cat([f.flatten(2) for f in feats], dim=2).transpose(1, 2).reshape(-1, c)
    base = (torch.arange(b, device=dev)[:, None] * sum(sizes) + offs)[:, :, None, None]
    wr = ws[:, :, None, None]

    def at(yi, xi):  # (B, R, P, P, C)
        idx = base + yi[:, :, :, None] * wr + xi[:, :, None, :]
        return torch.index_select(rows, 0, idx.reshape(-1)).reshape(*idx.shape, c)

    g = (at(y0i, x0i) * (1 - wx) * (1 - wy) + at(y0i, x1i) * wx * (1 - wy)
         + at(y1i, x0i) * (1 - wx) * wy + at(y1i, x1i) * wx * wy)
    g = g.reshape(b, r, pool, sampling, pool, sampling, c).mean(dim=(3, 5))
    return g.permute(0, 1, 4, 2, 3)


def fpn_level_for_boxes(boxes):
    """detectron2's level: floor(4 + log2(sqrt(area) / 224)), clamped to
    P2..P5, as index 0..3."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=1e-6)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8))
    return lvl.clamp(2, 5).long() - 2


def _top(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class ReferenceFasterRCNN(nn.Module):
    """The detector's loss (and, for counting FLOPs, its eval forward)."""

    def __init__(self, num_classes: int = 80, num_proposals: int = 256):
        super().__init__()
        self.nc = num_classes
        self.num_proposals = num_proposals
        self.model = D2FasterRCNN(num_classes)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, images: torch.Tensor):
        x = (images * 255.0 + 0.5).clamp(0, 255).permute(0, 3, 1, 2).flip(1)  # RGB -> BGR
        return self.model((x - self.pixel_mean) / self.pixel_std)

    def _proposals(self, fpn, rpn, image_hw, topk_per_level: int = 64):
        """The decoded RPN boxes of highest objectness, `topk_per_level`
        per level and `num_proposals` overall, clipped to the image and
        detached: (B, K, 4) boxes and (B, K) logits."""
        boxes_all, scores_all = [], []
        hi = torch.tensor([image_hw[1], image_hw[0], image_hw[1], image_hw[0]],
                          dtype=torch.float32, device=fpn[0].device)
        for lvl, (f, (obj, deltas)) in enumerate(zip(fpn, rpn)):
            b, _, h, w = f.shape
            anchors = make_level_anchors(h, w, 4 * 2**lvl, ANCHOR_SIZES[lvl], f.device)
            obj_f = obj.permute(0, 2, 3, 1).reshape(b, -1)
            d = deltas.permute(0, 2, 3, 1).reshape(b, -1, 4)
            top_s, top_i = _top(obj_f, min(topk_per_level, obj_f.shape[1]))
            boxes = decode_deltas(anchors[top_i], _take(d, top_i))
            boxes_all.append(torch.minimum(boxes.clamp(min=0), hi))
            scores_all.append(top_s)
        boxes = torch.cat(boxes_all, dim=1)
        top_s, top_i = _top(torch.cat(scores_all, dim=1), min(self.num_proposals, boxes.shape[1]))
        return _take(boxes, top_i).detach(), top_s.detach()

    def _roi_features(self, fpn, boxes):
        """ROIAlign of (B, R, 4) boxes, each on its FPN level (P2..P5):
        (B, R, C, POOL, POOL)."""
        return roi_align_levels(fpn[:4], boxes, fpn_level_for_boxes(boxes), (4, 8, 16, 32))

    def _sample_rois(self, props, obj_scores, gt, target: int):
        """The deterministic counterpart of detectron2's 512 at 25%
        positives: the GT boxes appended, proposals labelled by IoU >= 0.5
        against the GT box, the best positives by IoU (up to the 25%
        share), then the rest by objectness."""
        b = props.shape[0]
        props = torch.cat([props, gt], dim=1)
        obj_scores = torch.cat([obj_scores, obj_scores.new_full((b, gt.shape[1]), 1e6)], dim=1)
        ious = pairwise_iou_xyxy(props, gt).amax(dim=-1)  # (B, N)
        is_fg = ious >= 0.5
        n = props.shape[1]
        batch = min(ROI_BATCH, n)
        n_pos = int(batch * ROI_POS_FRACTION)
        pos_rank = torch.where(is_fg, 1e6 + ious, obj_scores)
        pos_sorted = torch.sort(torch.where(is_fg, ious, -1.0), dim=-1, descending=True).values
        pos_cut = pos_sorted[:, min(n_pos - 1, n - 1), None]
        rank = torch.where(is_fg & (ious < pos_cut), obj_scores, pos_rank)
        _, idx = _top(rank, batch)
        labels = torch.where(_take(is_fg, idx), int(target), self.nc)
        return _take(props, idx), labels

    def loss(self, images, target, bboxes):
        """The ROI head's classification loss, mean over ROIs and views."""
        images = images if images.ndim == 4 else images[None]
        b = images.shape[0]
        gt = torch.as_tensor(np.asarray(bboxes, np.float32), device=images.device)
        fpn, rpn = self(images)
        props, scores = self._proposals(fpn, rpn, images.shape[1:3])
        rois, labels = self._sample_rois(props, scores, gt.reshape(b, -1, 4), target)
        logits, _ = self.model.roi_heads(self._roi_features(fpn, rois).flatten(0, 1))
        ce = -torch.gather(F.log_softmax(logits, dim=-1), 1, labels.reshape(-1, 1))[:, 0]
        return ce.reshape(b, -1).mean(dim=1).mean()

    @torch.no_grad()
    def eval_forward(self, image):
        """The eval pass on one (1, H, W, 3) image up to the class scores:
        the work of one success check, for counting FLOPs."""
        fpn, rpn = self(image)
        props, _ = self._proposals(fpn, rpn, image.shape[1:3])
        return self.model.roi_heads(self._roi_features(fpn, props)[0])
