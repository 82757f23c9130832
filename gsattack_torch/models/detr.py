"""DETR, the torch-hub demo model: the port of `gsattack/models/detr.py`.

DETRdemo (the facebookresearch/detr colab model): a torchvision-v1
ResNet-50 trunk (stride in the 3x3, batch norms on stored statistics, eps
1e-5), a 1x1 conv to 256, `nn.Transformer(256, 8, 6, 6)` (post-LayerNorm,
relu, ffn 2048) with learned 50 x 128 row / column embeddings added once
to 0.1 * the features and 100 learned queries as the decoder input, then
`linear_class` (nc + 1) and `linear_bbox` (sigmoid cxcywh). The module
names are the demo checkpoint's keys (`backbone.layer1.0.bn1.weight`,
`transformer.encoder.layers.0.self_attn.in_proj_weight`, `query_pos`).

The loss is the DETR set criterion with every GT labelled `target`: each
GT takes the query of least (class, L1, GIoU) cost by a greedy match on
the device (exact for the attack's one box a view), then cross-entropy
(no-object weight 0.1) + 5 L1 + 2 GIoU. Images are (B, H, W, 3) in [0, 1],
normalised with ImageNet's mean and std.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .base import COCO_CLASSES, Detections, Detector, empty_detections, image_batch, nms
from .layers import FrozenBN, freeze, init_dense, normal_

D_MODEL = 256
FFN = 2048
HEADS = 8
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def TVBatchNorm(channels: int) -> FrozenBN:
    """torchvision's BatchNorm2d in evaluation mode (eps 1e-5)."""
    return FrozenBN(channels, eps=1e-5)


class TVBottleneck(nn.Module):
    """torchvision Bottleneck: the stride in conv2 (the 3x3)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        mid = cout // 4
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = TVBatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = TVBatchNorm(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = TVBatchNorm(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                         TVBatchNorm(cout)) if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        s = self.downsample(x) if self.downsample is not None else x
        return F.relu(s + h)


class TVResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = TVBatchNorm(64)
        cin = 64
        for li, (blocks, ch) in enumerate([(3, 256), (4, 512), (6, 1024), (3, 2048)]):
            stride = 1 if li == 0 else 2
            mods = [TVBottleneck(cin, ch, stride, downsample=True)]
            mods += [TVBottleneck(ch, ch) for _ in range(blocks - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))
            cin = ch

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x  # (B, 2048, H / 32, W / 32)


class DETRDemo(nn.Module):
    """The facebookresearch/detr colab demo model, batch first."""

    def __init__(self, nc: int = 91, num_queries: int = 100, enc_layers: int = 6,
                 dec_layers: int = 6):
        super().__init__()
        self.backbone = TVResNet50()
        self.conv = nn.Conv2d(2048, D_MODEL, 1)
        self.transformer = nn.Transformer(D_MODEL, HEADS, enc_layers, dec_layers, FFN,
                                          dropout=0.0, batch_first=True)
        self.linear_class = nn.Linear(D_MODEL, nc + 1)
        self.linear_bbox = nn.Linear(D_MODEL, 4)
        self.query_pos = nn.Parameter(torch.zeros(num_queries, D_MODEL))
        self.row_embed = nn.Parameter(torch.zeros(50, D_MODEL // 2))
        self.col_embed = nn.Parameter(torch.zeros(50, D_MODEL // 2))

    def forward(self, images: torch.Tensor):
        """(B, 3, H, W) normalised -> class logits (B, Q, nc + 1), boxes
        (B, Q, 4) cxcywh in [0, 1]."""
        h = self.conv(self.backbone(images))
        b, _, hh, ww = h.shape
        half = D_MODEL // 2
        pos = torch.cat([self.col_embed[None, :ww].expand(hh, ww, half),
                         self.row_embed[:hh, None].expand(hh, ww, half)], dim=-1)
        src = pos.reshape(1, hh * ww, D_MODEL) + 0.1 * h.flatten(2).transpose(1, 2)
        tgt = self.query_pos[None].expand(b, -1, -1)
        out = self.transformer(src, tgt)
        return self.linear_class(out), torch.sigmoid(self.linear_bbox(out))


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def giou_xyxy(a, b, eps=1e-7):
    """Generalised IoU of aligned (..., 4) boxes."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter + eps
    iou = inter / union
    cx1 = torch.minimum(a[..., 0], b[..., 0])
    cy1 = torch.minimum(a[..., 1], b[..., 1])
    cx2 = torch.maximum(a[..., 2], b[..., 2])
    cy2 = torch.maximum(a[..., 3], b[..., 3])
    carea = (cx2 - cx1) * (cy2 - cy1) + eps
    return iou - (carea - union) / carea


def hungarian_match(cost: np.ndarray) -> np.ndarray:
    """(Q, M) cost -> for each GT, its query under the exact assignment
    (scipy, on the host; for evaluation and tests)."""
    from scipy.optimize import linear_sum_assignment

    q_idx, m_idx = linear_sum_assignment(cost)
    out = np.zeros(cost.shape[1], np.int64)
    out[m_idx] = q_idx
    return out


def greedy_match(cost: torch.Tensor) -> torch.Tensor:
    """(..., Q, M) cost -> (..., M) query indices: each GT in order takes
    the unclaimed query of least cost (the first on a tie). Exact for one
    GT, the attack's case; on the device, no host round trip."""
    taken = torch.zeros(cost.shape[:-1], dtype=torch.bool, device=cost.device)
    out = []
    for i in range(cost.shape[-1]):
        j = torch.where(taken, math.inf, cost[..., i]).argmin(dim=-1)
        out.append(j)
        taken = taken.scatter(-1, j[..., None], True)
    return torch.stack(out, dim=-1)


class DetrDetector(nn.Module, Detector):
    name = "detr"

    def __init__(
        self,
        num_classes: int = 91,
        seed: int = 0,
        num_queries: int = 100,
        weights: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.nc = num_classes
        self.seed = seed
        self.num_queries = num_queries
        self.model = DETRDemo(num_classes, num_queries)
        self._init(torch.Generator().manual_seed(seed))
        if weights:
            from .convert_detr import load_into

            load_into(self.model, weights)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        freeze(self, dev)

    def _init(self, gen: torch.Generator) -> None:
        """flax's initialisers: lecun-normal convs and linears, packed
        attention projections xavier-uniform with zero bias, LayerNorm 1 /
        0, embeddings U(0, 1), queries N(0, 1)."""
        m = self.model
        init_dense(m, gen)
        with torch.no_grad():
            for name, p in m.transformer.named_parameters():
                if name.endswith("in_proj_weight"):
                    limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * limit)
                elif name.endswith("in_proj_bias"):
                    p.zero_()
                elif ".norm" in name or name.startswith("norm"):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
            m.col_embed.copy_(torch.rand(m.col_embed.shape, generator=gen))
            m.row_embed.copy_(torch.rand(m.row_embed.shape, generator=gen))
        normal_(m.query_pos, 1.0, gen)

    @property
    def device(self) -> torch.device:
        return self.mean.device

    @property
    def class_names(self):
        return COCO_CLASSES[: self.nc]

    def load_model(self) -> None:
        """The weights are made (or loaded) in the constructor."""

    def forward(self, images: torch.Tensor):
        """(B, H, W, 3) in [0, 1] -> (class logits, cxcywh boxes)."""
        return self.model((images.permute(0, 3, 1, 2) - self.mean) / self.std)

    def loss(self, images, target, bboxes):
        """The DETR set loss with every GT box labelled `target`, mean over
        the views."""
        images = images if images.ndim == 4 else images[None]
        b, h, w = images.shape[:3]
        gt = torch.as_tensor(np.asarray(bboxes, np.float32), device=images.device).reshape(b, -1, 4)
        gt = gt / torch.tensor([w, h, w, h], dtype=torch.float32, device=images.device)
        m = gt.shape[1]
        cls_logits, pboxes = self(images)
        p_xyxy = cxcywh_to_xyxy(pboxes)
        gt_cxcywh = torch.stack([(gt[..., 0] + gt[..., 2]) / 2, (gt[..., 1] + gt[..., 3]) / 2,
                                 gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]], dim=-1)
        prob = torch.softmax(cls_logits, dim=-1)
        cost = (-prob[..., target][..., None]
                + 5.0 * (pboxes[:, :, None, :] - gt_cxcywh[:, None]).abs().sum(-1)
                + 2.0 * -giou_xyxy(p_xyxy[:, :, None, :], gt[:, None]))
        matched = greedy_match(cost.detach())  # (B, M)
        tgt_cls = torch.full(cls_logits.shape[:2], self.nc, dtype=torch.long,
                             device=images.device).scatter(1, matched, int(target))
        weights = torch.full(cls_logits.shape[:2], 0.1, device=images.device).scatter(
            1, matched, 1.0)
        ce = -torch.gather(F.log_softmax(cls_logits, dim=-1), 2, tgt_cls[..., None])[..., 0]
        loss_ce = (ce * weights).sum(1) / weights.sum(1)
        idx = matched[..., None].expand(-1, -1, 4)
        loss_l1 = (torch.gather(pboxes, 1, idx) - gt_cxcywh).abs().sum(dim=(1, 2)) / m
        loss_giou = (1.0 - giou_xyxy(torch.gather(p_xyxy, 1, idx), gt)).sum(1) / m
        return (loss_ce + 5.0 * loss_l1 + 2.0 * loss_giou).mean()

    @torch.no_grad()
    def predict(self, image, threshold: float = 0.5) -> Detections:
        images = image_batch(image, self.device)
        h, w = images.shape[1:3]
        cls_logits, pboxes = self(images)
        conf, best = torch.softmax(cls_logits[0], dim=-1)[:, : self.nc].max(dim=-1)
        boxes = cxcywh_to_xyxy(pboxes[0]) * torch.tensor([w, h, w, h], dtype=torch.float32,
                                                         device=pboxes.device)
        keep_mask = (conf > threshold).cpu().numpy()
        if not keep_mask.any():
            return empty_detections()
        b = boxes.cpu().numpy()[keep_mask].clip(0, max(h, w))
        s = conf.cpu().numpy()[keep_mask]
        c = best.cpu().numpy()[keep_mask].astype(np.int64)
        keep = nms(b, s, iou_thres=0.5)
        return Detections(b[keep], s[keep], c[keep])
