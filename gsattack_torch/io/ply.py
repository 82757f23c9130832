"""PLY I/O for Gaussian scenes, the port of `gsattack/io/ply.py`, writing
the same bytes as the reference package: a binary little-endian float32
vertex table with the attribute order

  x y z nx ny nz f_dc_{0..2} f_rest_{0..3K-1} opacity scale_{0..2}
  rot_{0..3} obj_dc_{0..15}

and `f_rest` flattened channel-major ((N, 3, K) -> 3K columns), which is
why save and load transpose against the coefficient-major (N, K, 3)
layout in memory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.scene import NUM_OBJECTS, GaussianScene
from ..device import resolve_device

_PLY_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "int8": np.int8,
    "short": np.int16,
    "int16": np.int16,
    "ushort": np.uint16,
    "uint16": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
}


def read_ply_vertex_table(path: str) -> dict[str, np.ndarray]:
    """Parse a binary-little-endian or ascii PLY's 'vertex' element into a
    dict of column name -> (N,) array."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        cur: Optional[tuple[str, int, list]] = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex tables")
                if cur is None:
                    raise ValueError(f"{path}: property before any element")
                cur[2].append((parts[2], parts[1]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props]).newbyteorder("<")
            if fmt == "binary_little_endian":
                raw = f.read(dtype.itemsize * count)
                if len(raw) < dtype.itemsize * count:
                    raise ValueError(f"{path}: truncated '{name}' element")
                table = np.frombuffer(raw, dtype=dtype, count=count)
            else:
                rows = [f.readline().split() for _ in range(count)]
                table = np.array([tuple(r) for r in rows], dtype=dtype)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(table[p])
        return out


def write_ply_vertex_table(path: str, columns: list[tuple[str, np.ndarray]]) -> None:
    """Write a binary_little_endian PLY with a single float32 vertex table."""
    n = columns[0][1].shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in columns]
    header.append("end_header")
    data = np.stack([np.asarray(c, dtype=np.float32).reshape(n) for _, c in columns], axis=1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def save_scene_ply(scene: GaussianScene, path: str, compact: bool = True) -> None:
    """Serialize a scene (dead points dropped unless `compact=False`)."""
    sc = scene.compact() if compact else scene
    n = sc.num_points
    xyz = _np(sc.xyz)
    f_dc = _np(sc.f_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = _np(sc.f_rest).transpose(0, 2, 1).reshape(n, -1)
    obj_dc = _np(sc.obj_dc).transpose(0, 2, 1).reshape(n, -1)
    cols: list[tuple[str, np.ndarray]] = [
        ("x", xyz[:, 0]),
        ("y", xyz[:, 1]),
        ("z", xyz[:, 2]),
        ("nx", np.zeros(n, np.float32)),
        ("ny", np.zeros(n, np.float32)),
        ("nz", np.zeros(n, np.float32)),
    ]
    cols += [(f"f_dc_{i}", f_dc[:, i]) for i in range(f_dc.shape[1])]
    cols += [(f"f_rest_{i}", f_rest[:, i]) for i in range(f_rest.shape[1])]
    cols.append(("opacity", _np(sc.opacity_logit)[:, 0]))
    scale = _np(sc.log_scale)
    cols += [(f"scale_{i}", scale[:, i]) for i in range(scale.shape[1])]
    rot = _np(sc.quat)
    cols += [(f"rot_{i}", rot[:, i]) for i in range(rot.shape[1])]
    cols += [(f"obj_dc_{i}", obj_dc[:, i]) for i in range(obj_dc.shape[1])]
    write_ply_vertex_table(path, cols)


def load_scene_ply(
    path: str, max_sh_degree: int = 3, device: str | torch.device = "cuda"
) -> GaussianScene:
    """Load a scene PLY: `f_rest_*`, `scale_*` and `rot_*` sort by their
    numeric suffix, missing `obj_dc_*` become zeros, and the active SH
    degree is the maximum."""
    dev = resolve_device(device)
    t = read_ply_vertex_table(path)
    n = t["x"].shape[0]

    def sorted_cols(prefix):
        names = sorted((k for k in t if k.startswith(prefix)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([t[k] for k in names], axis=1) if names else None

    k_rest = (max_sh_degree + 1) ** 2 - 1
    rest = sorted_cols("f_rest_")
    if rest is None:
        rest = np.zeros((n, 3 * k_rest), np.float32)
    if rest.shape[1] != 3 * k_rest:
        raise ValueError(f"{path}: {rest.shape[1]} f_rest columns, want {3 * k_rest}")
    obj = sorted_cols("obj_dc_")
    if obj is None:
        obj = np.zeros((n, NUM_OBJECTS), np.float32)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return GaussianScene(
        xyz=tensor(np.stack([t["x"], t["y"], t["z"]], axis=1)),
        f_dc=tensor(np.stack([t["f_dc_0"], t["f_dc_1"], t["f_dc_2"]], axis=1)[:, None, :]),
        f_rest=tensor(rest.reshape(n, 3, k_rest).transpose(0, 2, 1)),
        log_scale=tensor(sorted_cols("scale_")),
        quat=tensor(sorted_cols("rot_")),
        opacity_logit=tensor(t["opacity"][:, None]),
        obj_dc=tensor(obj)[:, None, :],
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        active_sh_degree=max_sh_degree,
        max_sh_degree=max_sh_degree,
    )


def read_points_ply(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a plain point-cloud PLY -> (points, colours in [0, 1], normals),
    as the reference's `fetchPly`: colours default to 0.5 and normals to
    zeros when the file has none."""
    t = read_ply_vertex_table(path)
    pts = np.stack([t["x"], t["y"], t["z"]], axis=1).astype(np.float32)
    if "red" in t:
        cols = np.stack([t["red"], t["green"], t["blue"]], axis=1).astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in t:
        normals = np.stack([t["nx"], t["ny"], t["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def store_points_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a coloured point cloud (the reference's `storePly`): float32
    x y z and zero normals, then uchar red green blue; `rgb` in [0, 255]."""
    n = xyz.shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        *(f"property float {k}" for k in ("x", "y", "z", "nx", "ny", "nz")),
        *(f"property uchar {k}" for k in ("red", "green", "blue")),
        "end_header",
    ]
    dtype = np.dtype(
        [(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")]
    )
    table = np.zeros(n, dtype=dtype)
    for i, k in enumerate(("x", "y", "z")):
        table[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        table[k] = np.asarray(rgb[:, i], np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(table.tobytes())
