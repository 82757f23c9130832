"""Quaternion / covariance / projection-matrix math for 3DGS.

Port of `gsattack/core/transforms.py`. Conventions: quaternions are
(w, x, y, z); matrices act on column vectors (``p' = M @ p``). The view and
projection matrices are built on the host in numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def _safe_unit_quat(q: torch.Tensor) -> torch.Tensor:
    """q / ||q|| with a finite gradient at ||q|| = 0. The epsilon rounds
    away for any valid quaternion, so the normal path equals the plain
    form."""
    return q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3),
    normalising first."""
    q = _safe_unit_quat(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def covariance6(s: torch.Tensor, q: torch.Tensor, modifier: float = 1.0) -> torch.Tensor:
    """Activated 3D covariance packed (xx, xy, xz, yy, yz, zz), computed
    elementwise as Sigma_ij = sum_k s_k^2 R_ik R_jk (the reference's form)."""
    q = _safe_unit_quat(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s2 = torch.square(s * modifier)
    s0, s1, s2_ = s2[..., 0], s2[..., 1], s2[..., 2]
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2_ * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2_ * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2_ * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2_ * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2_ * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2_ * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def world_to_view_matrix(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World->camera 4x4 (column-vector convention), `getWorld2View2`
    semantics: R is the camera-to-world rotation, t the world->camera
    translation, with optional recentre/rescale of the camera centre."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def perspective_projection_matrix(
    znear: float, zfar: float, fovx: float, fovy: float
) -> np.ndarray:
    """OpenGL-style perspective matrix with z in [0, 1] (column vectors)."""
    tan_half_fovy = float(np.tan(fovy / 2))
    tan_half_fovx = float(np.tan(fovx / 2))
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * float(np.tan(fov / 2)))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * float(np.arctan(pixels / (2 * focal)))


def inverse_sigmoid(x):
    """log(x / (1 - x)); works on tensors and numpy arrays."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1 - x))
    return np.log(x / (1 - x))


def yaw_rotation_matrix(angle_deg: float) -> np.ndarray:
    """Y-axis rotation used by `CameraExtrinsics.yaw`."""
    theta = np.radians(angle_deg)
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
