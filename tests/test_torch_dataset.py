"""`gsattack_torch.io` (COLMAP, datasets, point PLY) against `gsattack.io`:
COLMAP text and binary models written as `tests/test_io.py` writes them,
read by both packages into the same cameras, FoVs, nerf++ normalisation,
shuffled order, eval split and alpha-masked images (equal, or 1e-6 for
floats); the points PLY each writes is byte-identical."""

import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from gsattack.io import colmap as jcm
from gsattack.io import dataset as jds
from gsattack.io import ply as jply
from gsattack_torch.io import colmap as tcm
from gsattack_torch.io import dataset as tds
from gsattack_torch.io import ply as tply
from tests.test_io import _write_colmap_text_scene


def _write_images(root, names):
    """RGBA (with a transparent and a half-transparent row), RGB, palette
    with transparency, and an unreadable file, by turns."""
    os.makedirs(root / "images", exist_ok=True)
    rng = np.random.default_rng(9)
    for i, name in enumerate(names):
        path = root / "images" / name
        kind = i % 4
        if kind == 0:
            rgba = rng.integers(0, 256, size=(48, 64, 4), dtype=np.uint8)
            rgba[0, :, 3] = 0
            rgba[1, :, 3] = 128
            Image.fromarray(rgba, "RGBA").save(path)
        elif kind == 1:
            Image.fromarray(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)).save(path)
        elif kind == 2:
            im = Image.fromarray(rng.integers(0, 4, size=(48, 64), dtype=np.uint8), "P")
            im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255] * 64)
            im.info["transparency"] = 0
            im.save(path, transparency=0)
        else:
            path.write_bytes(b"not an image")


def _write_colmap_binary_scene(root, n_cams=5):
    """A binary model, as `tests/test_io.py::test_colmap_binary_roundtrip`
    writes one: a PINHOLE and a SIMPLE_PINHOLE camera, images with
    points2D, points3D with tracks."""
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    rng = np.random.default_rng(11)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))
        f.write(struct.pack("<dddd", 60.0, 61.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 0, 80, 40))
        f.write(struct.pack("<ddd", 70.0, 40.0, 20.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_cams))
        for i in range(n_cams):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<idddddddi", 10 + i, *q, *rng.normal(size=3), 1 + i % 2))
            f.write(f"im_{(7 * i) % n_cams:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1))
            f.write(struct.pack("<ddq", 3.0, 4.0, 5))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 30))
        for i in range(30):
            f.write(struct.pack("<QdddBBBd", i, *rng.normal(size=3),
                                *rng.integers(0, 256, size=3).tolist(), 0.1))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 0, 0, 1, 1))
    return root


def _assert_same_cameras(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.width, a.height, a.uid, a.image_name) == (b.width, b.height, b.uid, b.image_name)
        np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.T, b.T, rtol=0, atol=1e-12)
        assert abs(a.fovx - b.fovx) <= 1e-6 and abs(a.fovy - b.fovy) <= 1e-6
        assert (a.image is None) == (b.image is None), a.image_name
        if b.image is not None:
            np.testing.assert_allclose(a.image, b.image, rtol=0, atol=1e-6)


def _assert_same_info(got, want):
    _assert_same_cameras(got.train_cameras, want.train_cameras)
    _assert_same_cameras(got.test_cameras, want.test_cameras)
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"], rtol=0, atol=1e-12)
    assert abs(got.nerf_normalization["radius"] - want.nerf_normalization["radius"]) <= 1e-12


def _both(tmp_path, writer, **kw):
    """Write one scene, copy it, and load one copy with each package: the
    points PLY each package writes on its first load must be the same
    bytes."""
    writer(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    want = jds.load_scene_info(str(tmp_path / "j"), **kw)
    got = tds.load_scene_info(str(tmp_path / "t"), **kw)
    assert open(got.ply_path, "rb").read() == open(want.ply_path, "rb").read()
    return got, want


@pytest.mark.parametrize("shuffle", [False, True])
def test_colmap_text_scene_matches(tmp_path, shuffle):
    def writer(root):
        _write_colmap_text_scene(root, n_cams=6)
        _write_images(root, [f"im_{i:03d}.png" for i in range(1, 7)])

    got, want = _both(tmp_path, writer, shuffle=shuffle)
    _assert_same_info(got, want)
    assert sum(c.image is not None for c in got.train_cameras) == 5  # one unreadable
    assert tds.sniff_scene_type(str(tmp_path / "t")) == "Colmap"


def test_colmap_binary_scene_matches(tmp_path):
    def writer(root):
        _write_colmap_binary_scene(root)
        _write_images(root, [f"im_{i:03d}.png" for i in range(5)])

    got, want = _both(tmp_path, writer, cam_indices=[3, 0, 9])
    _assert_same_info(got, want)
    assert len(got.train_cameras) == 2


def test_colmap_eval_split_and_resolution_match(tmp_path):
    _write_colmap_text_scene(tmp_path, n_cams=16)
    for res in (-1, 2, 32):
        got = tds.read_colmap_scene(str(tmp_path), eval_split=True, llffhold=8, resolution=res)
        want = jds.read_colmap_scene(str(tmp_path), eval_split=True, llffhold=8, resolution=res)
        assert (len(got.train_cameras), len(got.test_cameras)) == (14, 2)
        _assert_same_info(got, want)


def test_colmap_readers_and_quaternions_match(tmp_path):
    _write_colmap_binary_scene(tmp_path)
    sparse = str(tmp_path / "sparse" / "0")
    for name, fn in (("read_intrinsics_binary", "cameras.bin"),
                     ("read_extrinsics_binary", "images.bin")):
        got = getattr(tcm, name)(os.path.join(sparse, fn))
        want = getattr(jcm, name)(os.path.join(sparse, fn))
        assert got.keys() == want.keys()
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tcm.read_points3D_binary(os.path.join(sparse, "points3D.bin")),
                    jcm.read_points3D_binary(os.path.join(sparse, "points3D.bin"))):
        np.testing.assert_array_equal(a, b)
    q = np.random.default_rng(2).normal(size=4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(tcm.qvec2rotmat(q), jcm.qvec2rotmat(q))
    R = tcm.qvec2rotmat(q)
    np.testing.assert_allclose(tcm.rotmat2qvec(R), jcm.rotmat2qvec(R), atol=1e-12)


def test_colmap_text_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    cams = {1: tcm.ColmapCamera(1, "PINHOLE", 800, 600, rng.uniform(100, 900, size=4))}
    ims = {i: tcm.ColmapImage(i, rng.normal(size=4), rng.normal(size=3), 1, f"v{i}.png",
                              np.zeros((0, 2)), np.zeros(0, int)) for i in (1, 2)}
    for mod, d in ((tcm, "t"), (jcm, "j")):
        os.makedirs(tmp_path / d)
        mod.write_intrinsics_text(str(tmp_path / d / "cameras.txt"), cams)
        mod.write_extrinsics_text(str(tmp_path / d / "images.txt"), ims)
    for name in ("cameras.txt", "images.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_blender_scene_matches(tmp_path):
    def writer(root):
        os.makedirs(root)
        rng = np.random.default_rng(4)
        frames = []
        for i in range(3):
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3)
            frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
        with open(root / "transforms_train.json", "w") as f:
            json.dump({"camera_angle_x": 0.9, "w": 32, "h": 24, "frames": frames}, f)
        rgba = rng.integers(0, 256, size=(20, 30, 4), dtype=np.uint8)
        Image.fromarray(rgba, "RGBA").save(root / "r_1.png")

    for white in (False, True):
        got, want = _both(tmp_path / str(white), writer, white_background=white)
        _assert_same_info(got, want)
        assert got.points.shape == (100_000, 3)
        assert [c.width for c in got.train_cameras if c.image_name == "r_1"] == [30]


def test_points_ply_matches(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, size=(50, 3))
    tply.store_points_ply(str(tmp_path / "t" / "p.ply"), xyz, rgb)
    jply.store_points_ply(str(tmp_path / "j" / "p.ply"), xyz, rgb)
    assert (tmp_path / "t" / "p.ply").read_bytes() == (tmp_path / "j" / "p.ply").read_bytes()
    for a, b in zip(tply.read_points_ply(str(tmp_path / "t" / "p.ply")),
                    jply.read_points_ply(str(tmp_path / "j" / "p.ply"))):
        np.testing.assert_array_equal(a, b)


def test_resolution_policy_matches():
    for args in [(3200, 1600, -1), (800, 600, -1), (800, 600, 2), (800, 600, 400),
                 (1601, 900, -1, 2.0), (801, 601, 8), (1000, 500, 3)]:
        assert tds.apply_resolution_policy(*args) == jds.apply_resolution_policy(*args), args


def test_load_image_matches_and_needs_pillow(tmp_path, monkeypatch):
    _write_images(tmp_path, ["a.png", "b.png", "c.png", "d.png"])
    for name in ("a.png", "b.png", "c.png", "d.png", "missing.png"):
        path = str(tmp_path / "images" / name)
        got, want = tds._load_image(path), jds._load_image(path)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Without Pillow an existing image raises instead of loading as None;
    # a missing file still gives None.
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        tds._load_image(str(tmp_path / "images" / "a.png"))
    assert tds._load_image(str(tmp_path / "images" / "missing.png")) is None


def test_search_max_iteration_matches(tmp_path):
    for i in (7, 30000, 500):
        os.makedirs(tmp_path / f"iteration_{i}")
    assert tds.search_max_iteration(str(tmp_path)) == jds.search_max_iteration(str(tmp_path))
