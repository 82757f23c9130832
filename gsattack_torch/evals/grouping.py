"""Gaussian-Grouping scene evaluation, the port of
`gsattack/evals/grouping.py`: a PCA view of the 16-channel object-feature
renders, id -> RGB colour maps, per-camera render / GT / object dumps and
a side-by-side comparison video.

The PCA is computed here (numpy, float64), with scikit-learn's centring
and sign convention (`svd_flip` on the components), so no scikit-learn is
needed. The video needs OpenCV; without it `video` is None.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..io.png import to_uint8, write_png
from ..render import render


def pca3(flat: np.ndarray) -> np.ndarray:
    """(M, C) samples -> (M, 3) scores on the 3 leading principal
    components: centred, components from the eigenvectors of the
    covariance, each signed so that its largest-magnitude coefficient is
    positive (scikit-learn's `PCA(3).fit_transform`)."""
    x = np.asarray(flat, np.float64)
    x = x - x.mean(axis=0)
    evals, evecs = np.linalg.eigh(x.T @ x)
    comps = evecs[:, np.argsort(evals)[::-1][:3]].T
    rows = np.arange(comps.shape[0])
    comps *= np.sign(comps[rows, np.argmax(np.abs(comps), axis=1)])[:, None]
    return x @ comps.T


def feature_to_rgb(features_chw: np.ndarray) -> np.ndarray:
    """(C, H, W) object features -> (H, W, 3) uint8 of their PCA(3),
    scaled by the global min and max."""
    c, h, w = features_chw.shape
    rgb = pca3(np.asarray(features_chw).reshape(c, -1).T)
    rgb = (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-9)
    return (rgb.reshape(h, w, 3) * 255).astype(np.uint8)


def id2rgb(idx: np.ndarray, max_num_obj: int = 256) -> np.ndarray:
    """Object id -> colour from a fixed pseudo-random palette (numpy seed
    42), id 0 black."""
    rng = np.random.default_rng(42)
    palette = rng.integers(0, 255, size=(max_num_obj, 3), dtype=np.uint8)
    palette[0] = 0
    return palette[np.clip(idx, 0, max_num_obj - 1)]


def visualize_obj(objects_map: np.ndarray) -> np.ndarray:
    """(H, W) int object-id map -> (H, W, 3) uint8."""
    return id2rgb(objects_map)


def classify_pixels(obj_render_hwc: torch.Tensor, weight, bias) -> np.ndarray:
    """(H, W, 16) rendered object features -> (H, W) argmax class map of
    the 1x1-conv classifier."""
    w = torch.as_tensor(weight, dtype=torch.float32, device=obj_render_hwc.device)
    b = torch.as_tensor(bias, dtype=torch.float32, device=obj_render_hwc.device)
    logits = torch.einsum("hwc,kc->hwk", obj_render_hwc, w) + b
    return torch.argmax(logits, dim=-1).cpu().numpy()


def render_grouping_set(
    scene: GaussianScene,
    cameras: Sequence[Camera],
    out_dir: str,
    classifier: Optional[tuple] = None,
    gt_images: Optional[Sequence] = None,
    make_video: bool = True,
    bg: Optional[torch.Tensor] = None,
) -> dict:
    """Render each camera's RGB, PCA object features and (with a
    classifier) predicted object map as PNGs under `out_dir`, with the GT
    image when given; with `make_video`, write the side-by-side frames to
    `concat.mp4` when OpenCV is present (else `video` is None). Returns
    {"dirs", "video", "num_frames"}."""
    bg = torch.zeros(3, device=scene.device) if bg is None else bg
    dirs = {
        k: os.path.join(out_dir, k)
        for k in ("renders", "objects_feature16", "objects_pred", "gt", "concat")
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    frames = []
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            out = render(scene, cam, bg)
        rgb = to_uint8(out["render"])
        obj = out["render_object"]
        pca_rgb = feature_to_rgb(obj.cpu().numpy().transpose(2, 0, 1))
        write_png(os.path.join(dirs["renders"], f"{i:05d}.png"), rgb)
        write_png(os.path.join(dirs["objects_feature16"], f"{i:05d}.png"), pca_rgb)
        row = [rgb, pca_rgb]
        if classifier is not None:
            pred_rgb = visualize_obj(classify_pixels(obj, *classifier))
            write_png(os.path.join(dirs["objects_pred"], f"{i:05d}.png"), pred_rgb)
            row.append(pred_rgb)
        if gt_images is not None and i < len(gt_images):
            gt = to_uint8(gt_images[i])
            write_png(os.path.join(dirs["gt"], f"{i:05d}.png"), gt)
            row.insert(0, gt)
        frames.append(np.hstack(row))

    video_path = None
    if make_video and frames:
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            video_path = os.path.join(out_dir, "concat.mp4")
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
            for fr in frames:
                vw.write(fr[..., ::-1])  # RGB -> BGR
            vw.release()
    return {"dirs": dirs, "video": video_path, "num_frames": len(frames)}
