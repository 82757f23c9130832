"""`gsattack_torch.ops.knn.mean_knn_dist2` and `scene_from_points` without
`knn_dist2` against `gsattack` on the same numpy points (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.core import scene_from_points as j_scene_from_points
from gsattack.ops.knn import mean_knn_dist2 as j_knn
from gsattack_torch.core import scene_from_points as t_scene_from_points
from gsattack_torch.ops.knn import mean_knn_dist2 as t_knn
from tests.torch_port import np_

torch.set_num_threads(2)


@pytest.mark.parametrize("n,chunk", [(300, 128), (300, 300), (2, 64), (1, 8)])
def test_mean_knn_dist2_matches(n, chunk):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = t_knn(torch.tensor(pts), chunk=chunk)
    want = j_knn(jnp.asarray(pts), chunk=chunk)
    assert got.shape == (n,)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_scene_from_points_computes_the_3nn_scales():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    js = j_scene_from_points(pts, cols, max_sh_degree=2, key=jax.random.PRNGKey(3))
    ts = t_scene_from_points(pts, cols, max_sh_degree=2, device="cpu")
    np.testing.assert_allclose(np_(ts.log_scale), np.asarray(js.log_scale), rtol=1e-5, atol=1e-6)
    for k in ("xyz", "f_dc", "f_rest", "quat", "opacity_logit"):
        np.testing.assert_allclose(np_(getattr(ts, k)), np.asarray(getattr(js, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert ts.alive.all() and ts.active_sh_degree == 0 and ts.max_sh_degree == 2


def test_scene_from_points_carries_object_features_across():
    """The object features are random draws in both packages; the port's
    come from its generator, and carried across they are kept as given."""
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.uniform(size=(64, 3)).astype(np.float32)
    js = j_scene_from_points(pts, cols)
    ts = t_scene_from_points(pts, cols, device="cpu").replace(
        obj_dc=torch.tensor(np.asarray(js.obj_dc)))
    for k, v in js.params().items():
        np.testing.assert_allclose(np_(ts.params()[k]), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    again = t_scene_from_points(pts, cols, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.obj_dc, t_scene_from_points(pts, cols, device="cpu").obj_dc)


def test_oneup_sh_degree_stops_at_the_maximum():
    ts = t_scene_from_points(np.zeros((4, 3), np.float32) + np.arange(4)[:, None],
                             np.full((4, 3), 0.5, np.float32), max_sh_degree=1, device="cpu")
    assert ts.oneup_sh_degree().active_sh_degree == 1
    assert ts.oneup_sh_degree().oneup_sh_degree().active_sh_degree == 1
