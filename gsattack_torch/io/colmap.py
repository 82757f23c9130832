"""COLMAP sparse-reconstruction parsers (text and binary) and text
writers, pure numpy: the port's own copy of `gsattack/io/colmap.py`.
Intrinsics (cameras), extrinsics (images) and 3D points, in both
encodings, and the quaternion helpers.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_NPARAMS = {name: n for name, n in CAMERA_MODELS.values()}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix
    (`scene/colmap_loader.py:43-54` semantics)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion (eigen-decomposition method
    as `scene/colmap_loader.py:56-66`)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_next_bytes(f, num_bytes, fmt):
    return struct.unpack("<" + fmt, f.read(num_bytes))


# ---- text readers ---------------------------------------------------------


def read_intrinsics_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cid = int(elems[0])
            cams[cid] = ColmapCamera(
                id=cid,
                model=elems[1],
                width=int(elems[2]),
                height=int(elems[3]),
                params=np.array(tuple(map(float, elems[4:]))),
            )
    return cams


def read_extrinsics_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        # Keep blank lines: the format is strict line pairs (image row, then a
        # possibly-empty points2D row); only comments are skipped.
        lines = [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]
    while lines and not lines[0].strip():
        lines.pop(0)
    while lines and not lines[-1].strip():
        lines.pop()
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        iid = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        cam_id = int(elems[8])
        name = elems[9]
        if i + 1 < len(lines):
            pts = lines[i + 1].split()
            xys = np.column_stack(
                [
                    np.array(tuple(map(float, pts[0::3]))),
                    np.array(tuple(map(float, pts[1::3]))),
                ]
            ) if pts else np.zeros((0, 2))
            p3d = np.array(tuple(map(int, pts[2::3]))) if pts else np.zeros(0, int)
        else:
            xys, p3d = np.zeros((0, 2)), np.zeros(0, int)
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, p3d)
    return images


def read_points3D_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyzs.append(tuple(map(float, e[1:4])))
            rgbs.append(tuple(map(int, e[4:7])))
            errs.append(float(e[7]))
    return (
        np.array(xyzs, np.float64).reshape(-1, 3),
        np.array(rgbs, np.int64).reshape(-1, 3),
        np.array(errs, np.float64).reshape(-1, 1),
    )


# ---- binary readers -------------------------------------------------------


def read_intrinsics_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = _read_next_bytes(f, 8 * n_params, "d" * n_params)
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), np.array(params))
    return cams


def read_extrinsics_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num):
            props = _read_next_bytes(f, 64, "idddddddi")
            iid = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            cam_id = props[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read_next_bytes(f, 8, "Q")
            data = _read_next_bytes(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack(
                [np.array(data[0::3]), np.array(data[1::3])]
            ) if n_pts else np.zeros((0, 2))
            p3d = np.array(data[2::3], dtype=np.int64) if n_pts else np.zeros(0, int)
            images[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"), xys, p3d
            )
    return images


def read_points3D_binary(path: str):
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        xyzs = np.empty((num, 3))
        rgbs = np.empty((num, 3), np.int64)
        errs = np.empty((num, 1))
        for i in range(num):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            xyzs[i] = props[1:4]
            rgbs[i] = props[4:7]
            errs[i] = props[7]
            (track_len,) = _read_next_bytes(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyzs, rgbs, errs


# ---- text writers ---------------------------------------------------------


def write_intrinsics_text(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            params = " ".join(format(float(p), ".10g") for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_extrinsics_text(path: str, images: dict[int, ColmapImage]) -> None:
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            q = " ".join(format(float(v), ".17g") for v in im.qvec)
            t = " ".join(format(float(v), ".17g") for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write("\n")
