"""`gsattack_torch.core` against `gsattack.core` on the same numpy inputs:
quaternion / covariance / matrix math, SH evaluation, the scene class and
the cameras. Also the port's import rules: no JAX and nothing of
`gsattack` in the package or in `chip_smoke.py`."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.core import camera as jcam
from gsattack.core import scene as jscene
from gsattack.core import sh as jsh
from gsattack.core import transforms as jtf
from gsattack_torch.core import camera as tcam
from gsattack_torch.core import scene as tscene
from gsattack_torch.core import sh as tsh
from gsattack_torch.core import transforms as ttf
from gsattack_torch.device import resolve_device
from tests.conftest import make_toy_scene
from tests.torch_port import np_, port_scene

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-6
# Entries near zero come out of float32 cancellations (1 - 2(y^2 + z^2)),
# whose rounding the two frameworks order differently: 1e-6 of the
# largest value, absolute.
ATOL = 1e-6


def _quats(n=64, seed=0):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0  # the zero quaternion must stay finite
    return q


@pytest.mark.parametrize(
    "name", ["_safe_unit_quat", "quat_to_rotmat", "covariance6", "inverse_sigmoid"]
)
def test_quaternion_math_matches(name):
    rng = np.random.default_rng(1)
    q = _quats()
    s = np.exp(rng.normal(size=(64, 3)).astype(np.float32) * 0.5)
    p = rng.uniform(0.01, 0.99, size=(64,)).astype(np.float32)
    args = {
        "_safe_unit_quat": (q,),
        "quat_to_rotmat": (q,),
        "covariance6": (s, q, 1.3),
        "inverse_sigmoid": (p,),
    }[name]
    ref = getattr(jtf, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = getattr(ttf, name)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args))
    ref = np.asarray(ref)
    np.testing.assert_allclose(np_(got), ref, rtol=RTOL, atol=ATOL * np.abs(ref).max())


def test_view_projection_and_fov_helpers_match():
    rng = np.random.default_rng(2)
    R = ttf.yaw_rotation_matrix(17.0) @ jtf.yaw_rotation_matrix(-5.0).T
    t = rng.normal(size=3)
    trans = rng.normal(size=3)
    np.testing.assert_allclose(
        ttf.world_to_view_matrix(R, t, trans, 1.7),
        jtf.world_to_view_matrix(R, t, trans, 1.7), rtol=RTOL,
    )
    np.testing.assert_allclose(
        ttf.perspective_projection_matrix(0.01, 100.0, 1.1, 0.8),
        jtf.perspective_projection_matrix(0.01, 100.0, 1.1, 0.8), rtol=RTOL,
    )
    assert ttf.fov2focal(1.1, 640) == pytest.approx(jtf.fov2focal(1.1, 640), rel=RTOL)
    assert ttf.focal2fov(500.0, 640) == pytest.approx(jtf.focal2fov(500.0, 640), rel=RTOL)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_features_matches(deg):
    rng = np.random.default_rng(deg)
    feats = rng.normal(size=(40, (deg + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jsh.eval_sh_features(deg, jnp.asarray(feats), jnp.asarray(dirs))
    got = tsh.eval_sh_features(deg, torch.tensor(feats), torch.tensor(dirs))
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=RTOL, atol=ATOL)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tsh.rgb_to_sh(torch.tensor(rgb))), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
        rtol=RTOL,
    )
    assert tsh.C0 == jsh.C0


def test_scene_methods_match():
    js = make_toy_scene(n=24, seed=4)
    js = js.replace(alive=js.alive.at[3].set(False))
    ts = port_scene(js)
    np.testing.assert_allclose(
        np_(ts.covariance(0.8)), np.asarray(js.covariance(0.8)), rtol=RTOL, atol=1e-7
    )
    np.testing.assert_allclose(np_(ts.features), np.asarray(js.features), rtol=RTOL)
    np.testing.assert_allclose(np_(ts.opacity), np.asarray(js.opacity), rtol=RTOL)
    cat_j, cat_t = js.concat(js), ts.concat(ts)
    pad_j, pad_t = js.pad_to(30), ts.pad_to(30)
    com_j, com_t = js.compact(), ts.compact()
    for a, b in ((cat_j, cat_t), (pad_j, pad_t), (com_j, com_t)):
        for k, v in a.params().items():
            np.testing.assert_array_equal(np_(b.params()[k]), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(np_(b.alive), np.asarray(a.alive))
    p = {k: v * 2 for k, v in ts.params().items()}
    assert ts.with_params(p).xyz.data_ptr() == p["xyz"].data_ptr()


def test_scene_from_points_matches():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cols = rng.uniform(size=(20, 3)).astype(np.float32)
    knn = rng.uniform(1e-8, 1e-2, size=20).astype(np.float32)
    ref = jscene.scene_from_points(pts, cols, max_sh_degree=2, knn_dist2=knn)
    got = tscene.scene_from_points(pts, cols, max_sh_degree=2, knn_dist2=knn, device="cpu")
    for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit"):
        np.testing.assert_allclose(
            np_(getattr(got, k)), np.asarray(getattr(ref, k)), rtol=RTOL, err_msg=k
        )
    # Object features are random draws (another generator); same range.
    obj = np_(got.obj_dc) * tsh.C0 + 0.5
    assert obj.shape == (20, 1, 16) and obj.min() >= 0.0 and obj.max() < 1.0
    # Without knn_dist2 both compute the mean 3-NN distances themselves, the
    # cross term by a float32 matmul each (the 3-NN op's tolerance, 1e-5).
    ref = jscene.scene_from_points(pts, cols, max_sh_degree=2)
    got = tscene.scene_from_points(pts, cols, max_sh_degree=2, device="cpu")
    np.testing.assert_allclose(np_(got.log_scale), np.asarray(ref.log_scale), rtol=1e-5)


def test_camera_make_yaw_and_stack_match():
    R = np.eye(3)
    T = np.array([0.1, -0.2, 0.3])
    j = jcam.CameraExtrinsics(R, T, 1.0, 0.8, 48, 32).yaw(14.0)
    t = tcam.CameraExtrinsics(R, T, 1.0, 0.8, 48, 32).yaw(14.0)
    cj, ct = j.build(), t.build(device="cpu")
    for k in ("view", "full_proj", "cam_center", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(
            np_(getattr(ct, k)), np.asarray(getattr(cj, k)), rtol=RTOL, err_msg=k
        )
    st = tcam.stack_cameras([ct, t.translate(T * 2).build(device="cpu")])
    sj = jcam.stack_cameras([cj, j.translate(T * 2).build()])
    assert st.num_views == 2 and st.view.shape == (2, 4, 4)
    np.testing.assert_allclose(np_(st.full_proj), np.asarray(sj.full_proj), rtol=RTOL)
    np.testing.assert_array_equal(np_(st.view_at(1).view), np_(st.view[1]))


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcam.make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 8, 8)
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_gsattack():
    files = sorted((ROOT / "gsattack_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (f.relative_to(ROOT), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gsattack")
    ]
    assert not bad, bad
