"""Scene edits, the convex hull and the public names added with the CLI,
against the JAX package on the same numpy inputs: `ops/hull.py`,
`core/edit.py`, the SH / covariance helpers, `keep_only` /
`removal_setup`, `silhouette_bboxes`, `to_chw`, `render_oracle` and
`predict_and_save(result_dict=True)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.attack import silhouette as jsil
from gsattack.core import edit as jedit
from gsattack.core import sh as jsh
from gsattack.core import transforms as jtf
from gsattack.io import save_scene_ply as j_save_ply
from gsattack.models import ToyDetector as JToy
from gsattack.ops.hull import points_inside_convex_hull as j_hull
from gsattack.render import render_oracle as j_oracle
from gsattack.render import to_chw as j_to_chw
from gsattack_torch import ops as tops
from gsattack_torch.attack import silhouette_bboxes as t_bboxes
from gsattack_torch.convert import toy_detector_from_numpy
from gsattack_torch.core import edit as tedit
from gsattack_torch.core import sh as tsh
from gsattack_torch.core import transforms as ttf
from gsattack_torch.ops.hull import points_inside_convex_hull as t_hull
from gsattack_torch.render import render as t_render
from gsattack_torch.render import render_oracle as t_oracle
from gsattack_torch.render import to_chw as t_to_chw
from tests.conftest import make_toy_camera, make_toy_scene
from tests.torch_port import np_, port_camera, port_scene

torch.set_num_threads(2)
RNG = np.random.default_rng(21)


def _close(got, want, atol=1e-6, rtol=0.0, msg=""):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _scenes_close(got, want, atol=1e-6):
    for k, v in want.params().items():
        _close(got.params()[k], v, atol=atol, msg=k)
    np.testing.assert_array_equal(np_(got.alive), np.asarray(want.alive))
    assert (got.active_sh_degree, got.max_sh_degree) == (want.active_sh_degree,
                                                        want.max_sh_degree)


def test_convex_hull_matches():
    pts = RNG.normal(size=(400, 3)).astype(np.float32)
    pts[:5] *= 8.0  # outliers for the IQR filter
    for mask, kw in ((pts[:, 0] < 0.2, {}), (pts[:, 1] > 0.0, {"outlier_factor": 0.5}),
                     (pts[:, 2] > 0.5, {"remove_outliers": False}),
                     (np.arange(400) < 3, {})):  # too few points for a hull
        np.testing.assert_array_equal(t_hull(pts, mask, **kw), j_hull(pts, mask, **kw))
    flat = pts.copy()
    flat[:, 2] = 0.0  # a degenerate (planar) hull gives the mask itself
    mask = flat[:, 0] > 0
    np.testing.assert_array_equal(t_hull(flat, mask), j_hull(flat, mask))


def test_classifier_and_selection_mask_match():
    js = make_toy_scene(n=48, seed=2)
    ts = port_scene(js)
    w = RNG.normal(size=(6, 16)).astype(np.float32) * 0.5
    b = RNG.normal(size=6).astype(np.float32)
    _close(tedit.classifier_logits(ts.obj_dc, torch.tensor(w), torch.tensor(b)),
           jedit.classifier_logits(js.obj_dc, jnp.asarray(w), jnp.asarray(b)), atol=1e-6)
    for sel, thr in (([1, 3], 0.2), ([0], 0.3), ([5], 0.99)):
        want = jedit.object_selection_mask(js, jnp.asarray(w), jnp.asarray(b), sel, threshold=thr)
        got = tedit.object_selection_mask(ts, w, b, sel, threshold=thr)
        np.testing.assert_array_equal(got, want)


def test_keep_only_and_removal_setup_match():
    js = make_toy_scene(n=16, seed=4)
    mask = RNG.uniform(size=16) > 0.5
    ts = port_scene(js)
    for op in ("keep_only", "removal_setup"):
        np.testing.assert_array_equal(np_(getattr(ts, op)(mask).alive),
                                      np.asarray(getattr(js, op)(jnp.asarray(mask)).alive))
    _scenes_close(ts.keep_only(mask).compact(), js.keep_only(jnp.asarray(mask)).compact())


def test_combine_scene_plys_matches(tmp_path):
    paths = []
    for i, (n, deg) in enumerate(((20, 3), (12, 3), (7, 1))):
        p = str(tmp_path / f"s{i}.ply")
        j_save_ply(make_toy_scene(n=n, seed=i, max_sh_degree=deg), p)
        paths.append(p)
    for sel, deg in ((paths[:2], 3), (paths[2:], 1)):
        want, wmasks = jedit.combine_scene_plys(sel, max_sh_degree=deg)
        got, gmasks = tedit.combine_scene_plys(sel, max_sh_degree=deg, device="cpu")
        for k, v in want.params().items():
            np.testing.assert_array_equal(np_(got.params()[k]), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(np_(got.alive), np.asarray(want.alive))
        assert len(gmasks) == len(wmasks)
        for g, w in zip(gmasks, wmasks):
            np.testing.assert_array_equal(g, w)


def test_recolor_matches():
    js = make_toy_scene(n=24, seed=5)
    ts = port_scene(js)
    _scenes_close(tedit.recolor_single(ts, [0.2, 0.5, 0.9]),
                  jedit.recolor_single(js, [0.2, 0.5, 0.9]))
    _scenes_close(tedit.recolor_grayscale(ts), jedit.recolor_grayscale(js))
    _scenes_close(tedit.recolor_sepia(ts), jedit.recolor_sepia(js))
    key = jax.random.PRNGKey(7)
    draw = np.asarray(jax.random.uniform(key, (24, 1, 3)))
    _scenes_close(tedit.recolor_random(ts, rgb=torch.tensor(draw)), jedit.recolor_random(js, key))
    own = tedit.recolor_random(ts, generator=torch.Generator().manual_seed(1))
    rgb = tsh.sh_to_rgb_dc(own.f_dc)
    assert float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1 + 1e-6
    assert float(own.f_rest.abs().max()) == 0.0


def test_inpaint_scene_matches():
    js = make_toy_scene(n=40, seed=6)
    ts = port_scene(js)
    for mask in (RNG.uniform(size=40) > 0.7, np.zeros(40, bool)):
        _scenes_close(tedit.inpaint_scene(ts, mask, k=3),
                      jedit.inpaint_scene(js, jnp.asarray(mask), k=3))


def test_core_math_names_match():
    q = RNG.normal(size=(32, 4)).astype(np.float32)
    s = np.exp(RNG.normal(size=(32, 3))).astype(np.float32)
    _close(ttf.build_scaling_rotation(torch.tensor(s), torch.tensor(q)),
           jtf.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)), atol=1e-6, rtol=1e-6)
    cov = jtf.build_covariance(jnp.asarray(s), jnp.asarray(q))
    _close(ttf.build_covariance(torch.tensor(s), torch.tensor(q)), cov, atol=1e-6, rtol=1e-6)
    c = np.asarray(cov)
    _close(ttf.strip_symmetric(torch.tensor(c)), jtf.strip_symmetric(jnp.asarray(c)), atol=0)
    c6 = RNG.normal(size=(32, 6)).astype(np.float32)
    _close(ttf.unpack_symmetric(torch.tensor(c6)), jtf.unpack_symmetric(jnp.asarray(c6)), atol=0)
    dirs = RNG.normal(size=(32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(5):
        sh = RNG.normal(size=(32, 3, (deg + 1) ** 2)).astype(np.float32)
        for fn in ("eval_sh", "sh_to_rgb"):
            _close(getattr(tsh, fn)(deg, torch.tensor(sh), torch.tensor(dirs)),
                   getattr(jsh, fn)(deg, jnp.asarray(sh), jnp.asarray(dirs)),
                   atol=1e-6, rtol=1e-6, msg=f"{fn} {deg}")
    assert tops.mean_knn_dist2 is not None


def test_render_oracle_to_chw_and_bboxes_match():
    js = make_toy_scene(n=48, seed=0)
    jc = make_toy_camera(32, 32)
    ts, tc = port_scene(js), port_camera(jc)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = j_oracle(js, jc, jnp.asarray(bg))
    got = t_oracle(ts, tc, torch.tensor(bg))
    for k in ("render", "render_object", "final_transmittance"):
        _close(got[k], want[k], atol=2e-5, msg=k)
    np.testing.assert_array_equal(np_(got["radii"]), np.asarray(want["radii"]))
    # The oracle agrees with the tile renderer at the same scale.
    _close(got["render"], t_render(ts, tc, torch.tensor(bg))["render"], atol=2e-5)
    img = np_(got["render"])
    _close(t_to_chw(got["render"]), j_to_chw(jnp.asarray(img)), atol=0)
    imgs = np.stack([img, np.zeros_like(img), img[::-1]])
    np.testing.assert_array_equal(np_(t_bboxes(torch.tensor(imgs))),
                                  np.asarray(jsil.silhouette_bboxes(jnp.asarray(imgs))))


@pytest.mark.parametrize("gt", [True, False])
def test_predict_and_save_result_dict_matches(tmp_path, gt):
    jdet = JToy(num_classes=8, seed=3)
    jdet.load_model()
    tdet = toy_detector_from_numpy({k: np.asarray(v) for k, v in jdet.params.items()}, 8, 16,
                                   device="cpu")
    js = make_toy_scene(n=48, seed=1)
    img = np.asarray(j_oracle(js, make_toy_camera(48, 40), jnp.zeros(3))["render"])
    box = np.asarray(jsil.silhouette_bbox(jnp.asarray(img))) if gt else None
    kw = dict(target=2, untarget=None, is_targeted=True, threshold=0.0, gt_bbox=box,
              result_dict=True, image_id=5)
    ok_j, want = jdet.predict_and_save(jnp.asarray(img), path=str(tmp_path / "j.png"), **kw)
    ok_t, got = tdet.predict_and_save(torch.tensor(img), path=str(tmp_path / "t.png"), **kw)
    assert ok_t == ok_j and got.keys() == want.keys()
    assert len(want["detections"]) > 0
    assert (tmp_path / "t.png").exists()
    for k, v in want.items():
        if k == "detections":
            assert len(got[k]) == len(v)
            for a, b in zip(got[k], v):
                assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
                np.testing.assert_allclose(a["bbox"] + [a["score"]], b["bbox"] + [b["score"]],
                                           rtol=0, atol=1e-5)
        elif isinstance(v, (float, list)):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k
    assert tdet.predict_and_save(torch.tensor(img), threshold=0.0) == ok_j
