"""Weights and state carried across from the JAX package as numpy arrays,
so that both packages can run the same scene, detector and cameras.

The inputs are plain numpy: a `GaussianScene.params()` dict, the toy
detector's HWIO weights, and a camera's matrices. Every float array is
converted to float32 at this boundary.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.camera import Camera
from .core.scene import PARAM_NAMES, GaussianScene
from .device import resolve_device
from .models.toy import ToyDetector


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def scene_from_numpy(
    params: Mapping[str, np.ndarray],
    alive: np.ndarray,
    active_sh_degree: int,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """A scene from its parameter arrays (the names of
    `GaussianScene.params()`) and its `alive` mask; the maximum SH degree
    is the one `f_rest` holds."""
    dev = resolve_device(device)
    max_sh_degree = int(round(np.sqrt(np.shape(params["f_rest"])[1] + 1))) - 1
    return GaussianScene(
        **{name: _f32(params[name], dev) for name in PARAM_NAMES},
        alive=torch.tensor(np.asarray(alive, bool), device=dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=max_sh_degree,
    )


def toy_detector_from_numpy(
    params: Mapping[str, np.ndarray],
    num_classes: int,
    channels: int,
    device: str | torch.device = "cuda",
) -> ToyDetector:
    """A toy detector holding the given weights: convolution kernels
    w0, w1, w2 and wh in HWIO become OIHW; biases b0, b1, b2 and bh stay."""
    det = ToyDetector(num_classes=num_classes, channels=channels, device=device)
    dev = det.params["w0"].device
    with torch.no_grad():
        for name, value in params.items():
            a = np.asarray(value, np.float32)
            if name.startswith("w"):
                a = a.transpose(3, 2, 0, 1)
            if tuple(det.params[name].shape) != a.shape:
                raise ValueError(f"{name}: shape {a.shape}, want {tuple(det.params[name].shape)}")
            det.params[name].copy_(_f32(a, dev))
    return det


def camera_from_numpy(
    view: np.ndarray,
    full_proj: np.ndarray,
    cam_center: np.ndarray,
    tanfovx: float,
    tanfovy: float,
    width: int,
    height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """A camera from its world->camera and full projection matrices
    (column-vector convention), centre and tan half-FoVs."""
    dev = resolve_device(device)
    return Camera(
        view=_f32(view, dev),
        full_proj=_f32(full_proj, dev),
        cam_center=_f32(cam_center, dev),
        tanfovx=_f32(tanfovx, dev),
        tanfovy=_f32(tanfovy, dev),
        width=int(width),
        height=int(height),
    )
