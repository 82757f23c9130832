"""Oracle renderer, the port of `gsattack/render/oracle.py`: slow, exact,
per-pixel front-to-back alpha compositing over the globally depth-sorted
gaussians, one gaussian at a time, differentiable by autograd:

  power = -0.5 (A dx^2 + C dy^2) - B dx dy
  alpha = min(0.99, opacity * exp(power));  skip if power > 0 or alpha < 1/255
  test_T = T (1 - alpha);  if test_T < 1e-4: the pixel is done (no blend)
  C += color * alpha * T;  T = test_T
  out = C + T_final * bg

With `tile_aligned_cull=True` a gaussian touches only the pixels whose
16x16 tile overlaps its 3-sigma rect, as the tile rasterizer does. The
correctness anchor for the tile blend; not a production path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..ops.project import ProjectedGaussians, project

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def blend_oracle(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg: torch.Tensor,
    tile_aligned_cull: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential exact blend -> (image (H, W, 3 + C_obj), T_final (H, W))."""
    dev = proj.mean2d.device
    order = torch.argsort(proj.depth, stable=True)
    channels = torch.cat([proj.color, proj.obj], dim=-1)[order]
    mean2d, conic = proj.mean2d[order], proj.conic[order]
    opacity, radius = proj.opacity[order], proj.radius[order]
    n_ch = channels.shape[-1]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    tiles_x, tiles_y = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    tile_row = torch.arange(height, device=dev)[:, None] // TILE
    tile_col = torch.arange(width, device=dev)[None, :] // TILE

    def tile_range(c, rad, n):
        """Inria getRect: the tile range the radius box touches."""
        lo = torch.clamp((c - rad) / TILE, 0, n).to(torch.int32)
        hi = torch.clamp((c + rad + TILE - 1) / TILE, 0, n).to(torch.int32)
        return lo, hi

    accum = torch.zeros((height, width, n_ch), dtype=torch.float32, device=dev)
    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for g in range(mean2d.shape[0]):
        m2d, con, op, rad = mean2d[g], conic[g], opacity[g], radius[g]
        dx, dy = xs - m2d[0], ys - m2d[1]
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        # Clamped before exp: power > 0 is masked below, and an overflowed
        # exp would poison the gradient (inf * 0 = NaN).
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        use = (power <= 0.0) & (alpha >= ALPHA_MIN) & (rad > 0)
        if tile_aligned_cull:
            (x0, x1), (y0, y1) = tile_range(m2d[0], rad, tiles_x), tile_range(m2d[1], rad, tiles_y)
            use = use & (tile_col >= x0) & (tile_col < x1) & (tile_row >= y0) & (tile_row < y1)
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        test_T = T * (1.0 - alpha)
        crosses = use & (test_T < T_EPS) & ~done
        blend = use & ~done & ~crosses
        w = torch.where(blend, alpha * T, torch.zeros_like(alpha))
        accum = accum + w[..., None] * channels[g][None, None, :]
        T = torch.where(blend, test_T, T)
        done = done | crosses
    bg_full = torch.cat([bg, bg.new_zeros(n_ch - bg.shape[0])])
    return accum + T[..., None] * bg_full, T


def render_oracle(
    scene: GaussianScene,
    camera: Camera,
    bg: torch.Tensor,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    tile_aligned_cull: bool = True,
) -> dict:
    """Oracle render -> the output schema of `render` (`render`,
    `render_object`, `radii`, `visibility_filter`, `final_transmittance`)."""
    proj = project(scene, camera, scaling_modifier, override_color)
    image, T = blend_oracle(proj, camera.width, camera.height, bg, tile_aligned_cull)
    return {
        "render": image[..., :3],
        "render_object": image[..., 3:],
        "radii": proj.radius,
        "visibility_filter": proj.radius > 0,
        "final_transmittance": T,
    }
