"""Pinhole cameras for the reference: COLMAP-style extrinsics (R camera to
world, T world to camera) to the view and projection matrices, in numpy
float64 and then float32, with the 3DGS conventions (z in [0, 1], near
0.01, far 100)."""

from __future__ import annotations

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


def yaw(R: np.ndarray, degrees: float) -> np.ndarray:
    """R turned about the y axis: the program's yaw-augmented views."""
    th = np.radians(degrees)
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64) @ np.asarray(R)


def view_matrix(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(T)
    Rt[3, 3] = 1.0
    return np.linalg.inv(np.linalg.inv(Rt)).astype(np.float32)


def make_camera(R, T, fovx: float, fovy: float, width: int, height: int, device) -> dict:
    view = view_matrix(R, T)
    tx, ty = float(np.tan(fovx / 2)), float(np.tan(fovy / 2))
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = ZNEAR / (tx * ZNEAR)
    P[1, 1] = ZNEAR / (ty * ZNEAR)
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    full = (P @ view).astype(np.float32)
    center = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return {
        "view": torch.as_tensor(view, device=device),
        "full_proj": torch.as_tensor(full, device=device),
        "cam_center": torch.as_tensor(center, device=device),
        "tanfovx": torch.tensor(np.float32(np.tan(fovx * 0.5)), device=device),
        "tanfovy": torch.tensor(np.float32(np.tan(fovy * 0.5)), device=device),
        "width": int(width), "height": int(height),
    }


def nerfpp_radius(views: list) -> float:
    """1.1 times the largest distance of a camera centre from their mean
    (the 3DGS scene extent), from (R, T) pairs."""
    centers = np.stack([np.linalg.inv(view_matrix(R, T).astype(np.float64))[:3, 3]
                        for R, T in views])
    mid = centers.mean(axis=0)
    return float(np.linalg.norm(centers - mid, axis=1).max() * 1.1)
