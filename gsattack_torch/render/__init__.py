"""High-level render API, the port of `gsattack/render/__init__.py`:
images are (H, W, C) channel-last, as in the reference package."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..ops.project import project
from ..ops.raster import rasterize
from .oracle import render_oracle

__all__ = ["render", "render_oracle", "to_chw"]


def render(
    scene: GaussianScene,
    camera: Camera,
    bg: torch.Tensor,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    pairs_per_gaussian: int = 32,
    chunk: int = 64,
    max_chunks: int = 16,
    with_objects: bool = True,
    rect_candidates: int = 0,
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> dict:
    """Render one camera view. Returns `render`, `render_object`, `radii`,
    `visibility_filter`, `final_transmittance`, `num_culled_pairs` and
    `num_truncated_pairs`. A zero `mean2d_offset` that requires grad
    collects the screen-space mean gradients. `backend` and the caps as in
    `ops/raster.py::rasterize`."""
    proj = project(scene, camera, scaling_modifier, override_color)
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_offset)
    out = rasterize(
        proj, camera.width, camera.height, bg,
        pairs_per_gaussian=pairs_per_gaussian, chunk=chunk, max_chunks=max_chunks,
        with_objects=with_objects, rect_candidates=rect_candidates, backend=backend,
        pairs_budget=pairs_budget, compact_budget=compact_budget, tier_split=tier_split,
        heavy_budget=heavy_budget,
    )
    out["radii"] = proj.radius
    out["visibility_filter"] = proj.radius > 0
    return out


def to_chw(image_hwc: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (C, H, W), the reference's layout."""
    return image_hwc.permute(2, 0, 1)
