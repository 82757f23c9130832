"""Scene edits, the port of `gsattack/core/edit.py`: combine splat PLYs,
the grouped-object selection mask, inpainting, and recolouring.

  * `combine_scene_plys`: merge PLYs, keep a mask per source, zero the
    grouping features of the loaded splats;
  * `object_selection_mask`: the classifier + convex-hull mask of the
    grouped attack path;
  * `inpaint_scene`: remove points and re-add them from the mean of each
    one's k nearest remaining neighbours (scipy's KDTree, imported inside);
  * recolour tools (single / random / grayscale / sepia), higher SH bands
    zeroed.

Host-side set-up code; the tensors stay on the scene's device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import sh as shlib
from .scene import GaussianScene


def combine_scene_plys(
    ply_paths: Sequence[str], max_sh_degree: int = 3, device: str | torch.device = "cuda"
) -> tuple[GaussianScene, list[np.ndarray]]:
    """Merge scene PLYs into one scene on `device`, and a boolean mask per
    source: `masks[i]` is True on the rows `ply_paths[i]` contributed. The
    grouping features of the loaded splats are zeroed."""
    from ..io.ply import load_scene_ply

    parts = []
    for p in ply_paths:
        sc = load_scene_ply(p, max_sh_degree=max_sh_degree, device=device)
        parts.append(sc.replace(obj_dc=torch.zeros_like(sc.obj_dc)))
    if not parts:
        raise ValueError("No valid .ply files were loaded.")
    combined = parts[0]
    for sc in parts[1:]:
        combined = combined.concat(sc)
    masks, offset = [], 0
    for sc in parts:
        m = np.zeros(combined.num_points, dtype=bool)
        m[offset : offset + sc.num_points] = True
        masks.append(m)
        offset += sc.num_points
    return combined, masks


def classifier_logits(obj_dc: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """Per-point logits of the Gaussian-Grouping 1x1-conv classifier:
    obj_dc (N, 1, 16), weight (C, 16), bias (C,) -> (N, C)."""
    return obj_dc[:, 0, :] @ weight.T + bias


def object_selection_mask(
    scene: GaussianScene,
    weight,
    bias,
    selected_obj_ids: Sequence[int],
    threshold: float = 0.5,
    use_convex_hull: bool = True,
    outlier_factor: float = 1.0,
) -> np.ndarray:
    """softmax(classifier(obj_dc))[selected] > threshold, joined with the
    convex hull of the selected points -> (N,) bool numpy."""
    dev = scene.device
    w = torch.as_tensor(np.asarray(weight, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(bias, np.float32), device=dev)
    prob = torch.softmax(classifier_logits(scene.obj_dc, w, b), dim=-1)
    sel = torch.as_tensor(list(selected_obj_ids), dtype=torch.long, device=dev)
    mask_np = (prob[:, sel] > threshold).any(dim=-1).cpu().numpy()
    if use_convex_hull and mask_np.any():
        from ..ops.hull import points_inside_convex_hull

        hull = points_inside_convex_hull(
            scene.xyz.detach().cpu().numpy(), mask_np, outlier_factor=outlier_factor
        )
        mask_np = mask_np | hull
    return mask_np


def inpaint_scene(scene: GaussianScene, remove_mask: np.ndarray, k: int = 5) -> GaussianScene:
    """Remove the masked points and append one replacement per removed
    point, each parameter the mean over its k nearest remaining points."""
    from scipy.spatial import KDTree

    dev = scene.device
    remove_mask = np.asarray(remove_mask, dtype=bool)
    keep = scene.removal_setup(torch.as_tensor(remove_mask, device=dev)).compact()
    removed_xyz = scene.xyz.detach().cpu().numpy()[remove_mask]
    if removed_xyz.shape[0] == 0:
        return keep
    _, idx = KDTree(keep.xyz.detach().cpu().numpy()).query(
        removed_xyz, k=min(k, keep.num_points))
    idx = np.atleast_2d(idx)
    if idx.ndim == 1:
        idx = idx[:, None]

    def knn_mean(t: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(t.detach().cpu().numpy()[idx].mean(axis=1), device=dev)

    new = GaussianScene(
        **{name: knn_mean(t) for name, t in keep.params().items()},
        alive=torch.ones(removed_xyz.shape[0], dtype=torch.bool, device=dev),
        active_sh_degree=keep.active_sh_degree,
        max_sh_degree=keep.max_sh_degree,
    )
    return keep.concat(new)


# ---- recolour tools ---------------------------------------------------------


def _set_dc(scene: GaussianScene, f_dc: torch.Tensor) -> GaussianScene:
    """Overwrite the DC colour and zero every higher SH band."""
    return scene.replace(f_dc=f_dc, f_rest=torch.zeros_like(scene.f_rest))


def recolor_single(scene: GaussianScene, rgb: Sequence[float]) -> GaussianScene:
    sh = shlib.rgb_to_sh(torch.as_tensor(rgb, dtype=torch.float32, device=scene.device))
    return _set_dc(scene, sh[None, None, :].repeat(scene.num_points, 1, 1))


def recolor_random(
    scene: GaussianScene,
    generator: Optional[torch.Generator] = None,
    rgb: Optional[torch.Tensor] = None,
) -> GaussianScene:
    """A uniform random colour per point, drawn from `generator` (seed 0
    when None), or `rgb` (N, 1, 3) when given."""
    if rgb is None:
        generator = generator or torch.Generator().manual_seed(0)
        rgb = torch.rand((scene.num_points, 1, 3), generator=generator)
    rgb = torch.as_tensor(rgb, dtype=torch.float32).to(scene.device)
    return _set_dc(scene, shlib.rgb_to_sh(rgb))


def recolor_grayscale(scene: GaussianScene) -> GaussianScene:
    """The luminosity projection applied to the raw DC coefficients, then
    re-encoded: the reference's exact (quirky) arithmetic."""
    dc = scene.f_dc[:, 0, :]
    gray = 0.2989 * dc[:, 0] + 0.5870 * dc[:, 1] + 0.1140 * dc[:, 2]
    return _set_dc(scene, shlib.rgb_to_sh(torch.stack([gray] * 3, dim=-1)[:, None, :]))


def recolor_sepia(scene: GaussianScene) -> GaussianScene:
    dc = scene.f_dc[:, 0, :]
    m = torch.tensor(
        [[0.393, 0.769, 0.189], [0.349, 0.686, 0.168], [0.272, 0.534, 0.131]],
        dtype=torch.float32, device=scene.device,
    )
    return _set_dc(scene, shlib.rgb_to_sh(torch.clamp(dc @ m.T, 0.0, 1.0)[:, None, :]))
