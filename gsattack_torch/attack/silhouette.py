"""Silhouette ground-truth boxes, the port of
`gsattack/attack/silhouette.py`: ITU-R 601-2 luma of the byte-rounded
image (what PIL's convert('L') computes), threshold > 20, and PIL
getbbox's exclusive right/bottom convention."""

from __future__ import annotations

import torch

BW_THRESH = 20


@torch.no_grad()
def silhouette_bbox(image_hwc: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float [0, 1] -> (4,) int32 box (left, upper, right, lower),
    right/lower exclusive; zeros when nothing is above the threshold."""
    rgb = torch.round(torch.clamp(image_hwc, 0.0, 1.0) * 255.0)
    luma = torch.div(
        299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2], 1000,
        rounding_mode="floor",
    )
    mask = luma > BW_THRESH
    if not bool(mask.any()):
        return torch.zeros(4, dtype=torch.int32, device=image_hwc.device)
    rows = torch.nonzero(mask.any(dim=1))[:, 0]
    cols = torch.nonzero(mask.any(dim=0))[:, 0]
    box = torch.stack([cols.min(), rows.min(), cols.max() + 1, rows.max() + 1])
    return box.to(torch.int32)
