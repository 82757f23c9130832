"""Camera model: precomputed view / full-projection matrices (column-vector
convention) plus the image size. Port of `gsattack/core/camera.py`.

`stack_cameras` gives a Camera whose tensors carry a leading view
dimension; `Camera.view_at(i)` takes one view back out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .transforms import (
    perspective_projection_matrix,
    world_to_view_matrix,
    yaw_rotation_matrix,
)

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass
class Camera:
    view: torch.Tensor  # (4, 4) world->camera, or (V, 4, 4) when stacked
    full_proj: torch.Tensor  # (4, 4) proj @ view
    cam_center: torch.Tensor  # (3,) camera position in world space
    tanfovx: torch.Tensor  # scalar
    tanfovy: torch.Tensor  # scalar
    width: int
    height: int
    uid: int = 0
    image_name: str = ""

    @property
    def num_views(self) -> int:
        """Views in a stacked camera (1 for a single camera)."""
        return self.view.shape[0] if self.view.dim() == 3 else 1

    def view_at(self, i: int) -> "Camera":
        """View `i` of a stacked camera."""
        return dataclasses.replace(
            self,
            view=self.view[i],
            full_proj=self.full_proj[i],
            cam_center=self.cam_center[i],
            tanfovx=self.tanfovx[i],
            tanfovy=self.tanfovy[i],
        )


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    trans: Optional[np.ndarray] = None,
    scale: float = 1.0,
    uid: int = 0,
    image_name: str = "",
    znear: float = ZNEAR,
    zfar: float = ZFAR,
    device: str | torch.device = "cuda",
) -> Camera:
    """Build a Camera from COLMAP-style extrinsics: R is the camera-to-world
    rotation, T the world->camera translation."""
    dev = resolve_device(device)
    view = world_to_view_matrix(R, T, trans, scale)
    proj = perspective_projection_matrix(znear, zfar, fovx, fovy)
    full = (proj @ view).astype(np.float32)
    cam_center = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return Camera(
        view=torch.as_tensor(view, device=dev),
        full_proj=torch.as_tensor(full, device=dev),
        cam_center=torch.as_tensor(cam_center, device=dev),
        tanfovx=torch.tensor(np.float32(np.tan(fovx * 0.5)), device=dev),
        tanfovy=torch.tensor(np.float32(np.tan(fovy * 0.5)), device=dev),
        width=int(width),
        height=int(height),
        uid=uid,
        image_name=image_name,
    )


class CameraExtrinsics:
    """Host-side camera description (R, T, fov, size) that builds `Camera`s;
    carries the attack-time manipulation API (`translate` / `yaw`)."""

    def __init__(
        self,
        R: np.ndarray,
        T: np.ndarray,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        uid: int = 0,
        image_name: str = "",
        trans: Optional[np.ndarray] = None,
        scale: float = 1.0,
        image: Optional[np.ndarray] = None,
    ):
        self.R = np.asarray(R, dtype=np.float64)
        self.T = np.asarray(T, dtype=np.float64)
        self.fovx = float(fovx)
        self.fovy = float(fovy)
        self.width = int(width)
        self.height = int(height)
        self.uid = uid
        self.image_name = image_name
        self.trans = np.zeros(3) if trans is None else np.asarray(trans)
        self.scale = float(scale)
        self.image = image

    def translate(self, T: np.ndarray) -> "CameraExtrinsics":
        """Replace the camera translation."""
        out = self.copy()
        out.T = np.asarray(T, dtype=np.float64)
        return out

    def yaw(self, angle_deg: float) -> "CameraExtrinsics":
        """Premultiply R by a Y-axis rotation."""
        out = self.copy()
        out.R = yaw_rotation_matrix(angle_deg) @ self.R
        return out

    def copy(self) -> "CameraExtrinsics":
        return CameraExtrinsics(
            self.R.copy(), self.T.copy(), self.fovx, self.fovy, self.width,
            self.height, self.uid, self.image_name, self.trans.copy(),
            self.scale, self.image,
        )

    def build(self, device: str | torch.device = "cuda") -> Camera:
        return make_camera(
            self.R, self.T, self.fovx, self.fovy, self.width, self.height,
            self.trans, self.scale, uid=self.uid, image_name=self.image_name,
            device=device,
        )


def stack_cameras(cams: list[Camera]) -> Camera:
    """Stack same-resolution cameras into one with a leading view dim."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("resolutions differ")
    return Camera(
        view=torch.stack([c.view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        cam_center=torch.stack([c.cam_center for c in cams]),
        tanfovx=torch.stack([c.tanfovx for c in cams]),
        tanfovy=torch.stack([c.tanfovy for c in cams]),
        width=cams[0].width,
        height=cams[0].height,
    )
