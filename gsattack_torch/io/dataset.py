"""Scene and dataset loading: COLMAP and Blender scene directories ->
cameras and points. Port of `gsattack/io/dataset.py`.

Scene-type sniffing, camera assembly (R = qvec2rotmat(q)^T, FoV from the
focals, PINHOLE and SIMPLE_PINHOLE only), nerf++ normalisation (camera
centroid radius x 1.1), the llffhold-8 eval split, the deterministic
seed-42 shuffle, camera-subset selection, and the resolution policy of
the reference's `utils/camera_utils.py`.

Ground-truth images load when the file exists; a missing or unreadable
file gives None (the attack derives its boxes from renders). PNGs are read
by `io/png.py`; any other format (a COLMAP `.jpg`) needs Pillow, and a
missing Pillow raises an ImportError that names the file.
"""

from __future__ import annotations

import json
import os
import random
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.camera import CameraExtrinsics
from ..core.sh import sh_to_rgb_dc
from ..core.transforms import focal2fov, fov2focal, world_to_view_matrix
from . import colmap as cm
from . import png
from .ply import read_points_ply, store_points_ply


@dataclass
class SceneInfo:
    train_cameras: list[CameraExtrinsics]
    test_cameras: list[CameraExtrinsics]
    points: Optional[np.ndarray]
    colors: Optional[np.ndarray]
    normals: Optional[np.ndarray]
    nerf_normalization: dict
    ply_path: str = ""


def get_nerfpp_norm(cams: list[CameraExtrinsics]) -> dict:
    """Camera-centroid radius x 1.1 (`getNerfppNorm`)."""
    centers = []
    for cam in cams:
        w2c = world_to_view_matrix(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=1)
    center = centers.mean(axis=1, keepdims=True)
    diagonal = float(np.max(np.linalg.norm(centers - center, axis=0)))
    return {"translate": -center.flatten(), "radius": diagonal * 1.1}


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """An image file as (H, W, C) uint8 in `mode`, "RGB" or "RGBA" as
    Pillow's `convert` gives it; with `mode` None, "RGBA" when the image
    carries alpha (an RGBA, LA or PA image, or a palette image with
    transparency), else "RGB". PNG is decoded by `io/png.py`, any other
    format by Pillow."""
    if png.is_png(path):
        px = png.read_png(path)
        return png.convert(px, mode or ("RGBA" if px.shape[-1] in (2, 4) else "RGB"))
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs Pillow: only PNG is read without it") from e
    with Image.open(path) as im:
        if mode is None:
            alpha = im.mode in ("RGBA", "LA", "PA") or (
                im.mode == "P" and "transparency" in im.info)
            mode = "RGBA" if alpha else "RGB"
        return np.asarray(im.convert(mode))


def _load_image(path: str) -> Optional[np.ndarray]:
    """GT image as (H, W, 3) in [0, 1], or None when the file is missing or
    unreadable. An image with an alpha channel is multiplied by it (the
    reference's camera-level gt_alpha_mask)."""
    if not os.path.exists(path):
        return None
    try:
        px = read_image(path)
    except (OSError, ValueError, zlib.error):
        return None
    if px.shape[-1] == 4:
        rgba = px.astype(np.float32) / 255.0
        return rgba[..., :3] * rgba[..., 3:4]
    return px.astype(np.float32) / 255.0


def apply_resolution_policy(
    width: int, height: int, resolution: int = -1, resolution_scale: float = 1.0
) -> tuple[int, int]:
    """Divisors {1, 2, 4, 8}, a target width, or -1: cap the width at
    1600 px."""
    if resolution in (1, 2, 4, 8):
        return (
            round(width / (resolution_scale * resolution)),
            round(height / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = width / 1600 if width > 1600 else 1.0
    else:
        global_down = width / resolution
    scale = global_down * resolution_scale
    return round(width / scale), round(height / scale)


def read_colmap_cameras(
    extrinsics: dict[int, cm.ColmapImage],
    intrinsics: dict[int, cm.ColmapCamera],
    images_folder: str,
    resolution: int = -1,
) -> list[CameraExtrinsics]:
    cams = []
    for key in extrinsics:
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = cm.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(
                f"COLMAP camera model not handled: {intr.model} (PINHOLE or "
                "SIMPLE_PINHOLE only, as the reference)"
            )
        w, h = apply_resolution_policy(intr.width, intr.height, resolution)
        name = os.path.basename(extr.name)
        img = _load_image(os.path.join(images_folder, name))
        cams.append(
            CameraExtrinsics(
                R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h, uid=intr.id,
                image_name=os.path.splitext(name)[0], image=img,
            )
        )
    return cams


def read_colmap_scene(
    path: str, images: str = "images", eval_split: bool = False,
    llffhold: int = 8, resolution: int = -1,
) -> SceneInfo:
    """`readColmapSceneInfo`: the binary model with the text one as
    fallback, every llffhold-th camera held out under `eval_split`, and
    points3D.bin / .txt converted to points3D.ply on the first load."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = cm.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        intr = cm.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, struct.error):
        extr = cm.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = cm.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    cams = read_colmap_cameras(extr, intr, os.path.join(path, images), resolution)
    cams = sorted(cams, key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    ply_path = os.path.join(sparse, "points3D.ply")
    pts = cols = normals = None
    if not os.path.exists(ply_path):
        for reader, fn in (
            (cm.read_points3D_binary, "points3D.bin"),
            (cm.read_points3D_text, "points3D.txt"),
        ):
            fp = os.path.join(sparse, fn)
            if os.path.exists(fp):
                xyz, rgb, _ = reader(fp)
                store_points_ply(ply_path, xyz, rgb)
                break
    if os.path.exists(ply_path):
        pts, cols, normals = read_points_ply(ply_path)

    return SceneInfo(
        train_cameras=train,
        test_cameras=test,
        points=pts,
        colors=cols,
        normals=normals,
        nerf_normalization=get_nerfpp_norm(train if train else cams),
        ply_path=ply_path,
    )


def read_blender_cameras(
    path: str, transformsfile: str, white_background: bool, extension: str = ".png"
) -> list[CameraExtrinsics]:
    """`readCamerasFromTransforms`: OpenGL -> COLMAP axis flip, images
    alpha-composited onto the background colour."""
    cams = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender (Y up, Z back) -> COLMAP
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        img_path = os.path.join(path, frame["file_path"] + extension)
        img = None
        w = h = None
        if os.path.exists(img_path):
            rgba = read_image(img_path, "RGBA").astype(np.float32) / 255.0
            bg = np.ones(3) if white_background else np.zeros(3)
            img = rgba[..., :3] * rgba[..., 3:4] + bg * (1 - rgba[..., 3:4])
            h, w = img.shape[:2]
        if w is None:
            w = int(contents.get("w", 800))
            h = int(contents.get("h", 800))
        fovy = focal2fov(fov2focal(fovx, w), h)
        cams.append(
            CameraExtrinsics(
                R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
                uid=idx, image_name=os.path.splitext(os.path.basename(img_path))[0],
                image=img,
            )
        )
    return cams


def read_blender_scene(
    path: str, white_background: bool = False, eval_split: bool = False,
    extension: str = ".png",
) -> SceneInfo:
    """`readNerfSyntheticInfo`: a random 100k-point cloud (numpy seed 0)
    when the directory has none."""
    train = read_blender_cameras(path, "transforms_train.json", white_background, extension)
    test_file = os.path.join(path, "transforms_test.json")
    test = (
        read_blender_cameras(path, "transforms_test.json", white_background, extension)
        if os.path.exists(test_file)
        else []
    )
    if not eval_split:
        train = train + test
        test = []
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_points_ply(ply_path, xyz, sh_to_rgb_dc(shs) * 255)
    pts, cols, normals = read_points_ply(ply_path)
    return SceneInfo(
        train_cameras=train,
        test_cameras=test,
        points=pts,
        colors=cols,
        normals=normals,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )


scene_load_callbacks = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
}


def sniff_scene_type(path: str) -> str:
    """A sparse/ directory means COLMAP, a transforms_train.json Blender."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"Could not recognize scene type for {path}")


def load_scene_info(
    path: str,
    images: str = "images",
    eval_split: bool = False,
    white_background: bool = False,
    resolution: int = -1,
    shuffle: bool = True,
    cam_indices: Optional[list[int]] = None,
) -> SceneInfo:
    """The whole scene load of the reference's `Scene.__init__`: the
    deterministic seed-42 camera shuffle and an optional camera subset."""
    kind = sniff_scene_type(path)
    if kind == "Colmap":
        info = read_colmap_scene(path, images, eval_split, resolution=resolution)
    else:
        info = read_blender_scene(path, white_background, eval_split)
    if shuffle:
        rnd = random.Random(42)
        rnd.shuffle(info.train_cameras)
        rnd.shuffle(info.test_cameras)
    if cam_indices:
        info.train_cameras = [
            info.train_cameras[i] for i in cam_indices if i < len(info.train_cameras)
        ]
    return info


def search_max_iteration(point_cloud_dir: str) -> int:
    """`searchForMaxIteration`: the largest N of the iteration_N
    directories."""
    iters = [
        int(d.split("_")[-1])
        for d in os.listdir(point_cloud_dir)
        if d.startswith("iteration_")
    ]
    return max(iters)
