"""Per-Gaussian projection: frustum cull, EWA 3D->2D covariance, SH colour.

Port of `gsattack/ops/project.py`, plain PyTorch autograd code. Conventions
of the Inria rasterizer's preprocess:
  * near-plane cull at view-space z <= 0.2
  * EWA Jacobian with tan-FoV clamping at 1.3x the frustum half-extent
  * +0.3 px low-pass added to the 2D covariance diagonal
  * radius = ceil(3 * sqrt(lambda_max)), 16-px tiles downstream
  * ndc2pix(v, S) = ((v + 1) * S - 1) / 2

`torch.where` leaks NaN gradients from the branch it does not take exactly
as `jnp.where` does, so the double-where guards of the reference are kept.

`project` runs in the span `render/project` (`utils/profiling.py`). Its
backward is plain autograd, run by the autograd engine (on a card, on the
engine's own thread): a trace's reader puts those nodes down to
`render/project` by the sequence numbers the profiler records on each
forward op and on its backward node.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import sh as shlib
from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..utils.profiling import annotate_fn


def _affine3(xyz: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(N, 3) @ rot.T + trans, written out per row in the reference's
    summation order (x*r0 + y*r1 + z*r2 + t)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = [
        x * rot[i, 0] + y * rot[i, 1] + z * rot[i, 2] + trans[i]
        for i in range(rot.shape[0])
    ]
    return torch.stack(cols, dim=-1)


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with `jnp.maximum`'s gradient (split evenly at a tie)."""
    return torch.maximum(x, torch.zeros_like(x))


class ProjectedGaussians(NamedTuple):
    """Screen-space quantities for every Gaussian (dense over capacity N);
    `stack_projections` adds a leading view dimension to every field."""

    mean2d: torch.Tensor  # (N, 2) pixel coords
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # (N,) int32 screen radius in pixels (0 = culled)
    color: torch.Tensor  # (N, 3) RGB from SH (or override)
    obj: torch.Tensor  # (N, C_obj) object features
    opacity: torch.Tensor  # (N,) activated opacity
    # Opacity-aware binning radius (<= radius): beyond
    # sqrt(2 ln(255 op) lambda1) every pixel fails the blend's 1/255 skip.
    radius_tight: torch.Tensor  # (N,) float32 (0 = culled)


def stack_projections(projs: list[ProjectedGaussians]) -> ProjectedGaussians:
    """Per-view projections -> one with a leading view dimension."""
    return ProjectedGaussians(*(torch.stack(f) for f in zip(*projs)))


def compute_cov2d(
    xyz: torch.Tensor,
    cov3d6: torch.Tensor,
    view: torch.Tensor,
    tanfovx: torch.Tensor,
    tanfovy: torch.Tensor,
    width: int,
    height: int,
) -> torch.Tensor:
    """EWA splatting: project the packed 3D covariance to screen space.
    Returns (N, 3) packed (cov_xx, cov_xy, cov_yy) with the +0.3 low-pass
    on the diagonal."""
    t = _affine3(xyz, view[:3, :3], view[:3, 3])
    # Double-where guard: points at/behind the near plane are culled later,
    # but a raw 1/tz would poison the gradients of masked-out rows with NaN.
    tz = torch.where(t[:, 2] > 0.2, t[:, 2], torch.ones_like(t[:, 2]))
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txtz = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx)
    tytz = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy)
    tx = txtz * tz
    ty = tytz * tz

    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)

    # J rows (fx/tz, 0, -fx tx/tz^2) and (0, fy/tz, -fy ty/tz^2); M = J W,
    # and the quadratic form M V M^T elementwise on the packed 6-vector.
    j00 = fx / tz
    j02 = -fx * tx / (tz * tz)
    j11 = fy / tz
    j12 = -fy * ty / (tz * tz)
    W = view[:3, :3]
    m0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]
    m1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]

    xx, xy, xz = cov3d6[:, 0], cov3d6[:, 1], cov3d6[:, 2]
    yy, yz, zz = cov3d6[:, 3], cov3d6[:, 4], cov3d6[:, 5]

    def quad(a, b):
        return (
            xx * a[:, 0] * b[:, 0]
            + yy * a[:, 1] * b[:, 1]
            + zz * a[:, 2] * b[:, 2]
            + xy * (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0])
            + xz * (a[:, 0] * b[:, 2] + a[:, 2] * b[:, 0])
            + yz * (a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1])
        )

    return torch.stack(
        [quad(m0, m0) + 0.3, quad(m0, m1), quad(m1, m1) + 0.3], dim=-1
    )


@annotate_fn("render/project")
def project(
    scene: GaussianScene,
    camera: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
) -> ProjectedGaussians:
    """Dense projection of every Gaussian in the scene for one camera."""
    xyz = scene.xyz
    view = camera.view
    full = camera.full_proj

    depth = _affine3(xyz, view[2:3, :3], view[2:3, 3])[:, 0]
    in_front = depth > 0.2

    hom = _affine3(xyz, full[:3, :3], full[:3, 3])
    w = _affine3(xyz, full[3:4, :3], full[3:4, 3])[:, 0]
    # Same double-where guard as the covariance path.
    w = torch.where(in_front, w, torch.ones_like(w))
    inv_w = 1.0 / (w + 1e-7)
    ndc = hom * inv_w[:, None]
    mean2d = torch.stack(
        [
            ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5,
            ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5,
        ],
        dim=-1,
    )

    cov3d6 = scene.covariance(scaling_modifier)
    cov2d = compute_cov2d(
        xyz, cov3d6, view, camera.tanfovx, camera.tanfovy, camera.width, camera.height
    )
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det != 0.0
    one = torch.ones_like(det)
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, one), torch.zeros_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.maximum(mid * mid - det, torch.full_like(det, 0.1)))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(_relu0(lambda1)))
    visible = in_front & det_ok & scene.alive
    zero = torch.zeros_like(radius_f)
    radius = torch.where(visible, radius_f, zero).to(torch.int32)

    # Tight binning radius (opacity-aware cutoff): alpha along the major
    # axis is op*exp(-d^2/(2 lambda1)), which crosses the 1/255 skip at
    # d^2 = 2 lambda1 ln(255 op); +0.01 px keeps f32 boundary cases.
    opacity_act = torch.sigmoid(scene.opacity_logit[:, 0]) * scene.alive
    q_cut = 2.0 * torch.log(torch.clamp(opacity_act * 255.0, min=1e-6))
    r_tight = torch.sqrt(_relu0(q_cut) * _relu0(lambda1))
    radius_tight = torch.where(
        visible, torch.minimum(radius_f, r_tight + 0.01), zero
    )

    if override_color is not None:
        color = override_color
    else:
        deg = scene.active_sh_degree if sh_degree is None else sh_degree
        dirs = xyz - camera.cam_center[None, :]
        # Double-where guard: a point exactly at the camera centre has
        # dirs == 0, where the norm's gradient is 0/0.
        n2 = torch.sum(dirs * dirs, dim=-1, keepdim=True)
        safe = n2 > 1e-18
        inv = 1.0 / torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
        dirs = torch.where(safe, dirs * inv, torch.zeros_like(dirs))
        color = _relu0(shlib.eval_sh_features(deg, scene.features, dirs) + 0.5)

    # Object features, blended like degree-0 SH.
    obj = _relu0(scene.obj_dc[:, 0, :] * shlib.C0 + 0.5)

    return ProjectedGaussians(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        radius=radius,
        color=color,
        obj=obj,
        opacity=opacity_act,
        radius_tight=radius_tight,
    )
