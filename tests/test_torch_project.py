"""`gsattack_torch.ops.project` against `gsattack.ops.project` on the same
scene and camera: every output, and the VJP into every scene parameter,
at rtol/atol 1e-5 (float32 elementwise math in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.ops.project import compute_cov2d as j_cov2d
from gsattack.ops.project import project as j_project
from gsattack_torch.ops.project import compute_cov2d as t_cov2d
from gsattack_torch.ops.project import project as t_project
from tests.conftest import make_toy_camera, make_toy_scene
from tests.torch_port import np_, port_camera, port_scene

torch.set_num_threads(2)

FIELDS = ("mean2d", "depth", "conic", "color", "obj", "opacity", "radius_tight")


def _scene(seed):
    sc = make_toy_scene(n=64, seed=seed).replace(active_sh_degree=3)
    # One point behind the camera and one dead point: culled, finite grads.
    xyz = sc.xyz.at[0].set(jnp.array([0.1, 0.2, -1.0]))
    return sc.replace(xyz=xyz, alive=sc.alive.at[1].set(False))


@pytest.mark.parametrize("seed", [0, 1])
def test_project_outputs_match(seed):
    sc, cam = _scene(seed), make_toy_camera(width=40, height=32)
    ref = j_project(sc, cam)
    got = t_project(port_scene(sc), port_camera(cam))
    for f in FIELDS:
        np.testing.assert_allclose(
            np_(getattr(got, f)), np.asarray(getattr(ref, f)), rtol=1e-5, atol=1e-5,
            err_msg=f,
        )
    np.testing.assert_array_equal(np_(got.radius), np.asarray(ref.radius))
    assert (np_(got.radius) > 0).sum() > 40 and np_(got.radius)[[0, 1]].tolist() == [0, 0]


def test_compute_cov2d_matches():
    sc, cam = _scene(2), make_toy_camera(width=48, height=48)
    cov6 = sc.covariance()
    ref = j_cov2d(sc.xyz, cov6, cam.view, cam.tanfovx, cam.tanfovy, 48, 48)
    tc = port_camera(cam)
    got = t_cov2d(
        torch.tensor(np.asarray(sc.xyz)), torch.tensor(np.asarray(cov6)), tc.view,
        tc.tanfovx, tc.tanfovy, 48, 48,
    )
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_project_vjp_matches_every_parameter():
    sc, cam = _scene(3), make_toy_camera(width=40, height=32)
    rng = np.random.default_rng(3)
    ref_out = j_project(sc, cam)
    # radius_tight feeds only the (non-differentiable) binning; its sqrt at
    # 0 gives the culled rows NaN gradients in the reference too.
    fields = FIELDS[:-1]
    weights = {
        f: rng.normal(size=np.shape(getattr(ref_out, f))).astype(np.float32) for f in fields
    }

    def j_loss(params):
        out = j_project(sc.with_params(params), cam)
        return sum(jnp.sum(getattr(out, f) * weights[f]) for f in fields)

    g_ref = jax.grad(j_loss)(sc.params())
    ts = port_scene(sc)
    leaves = {k: v.clone().requires_grad_(True) for k, v in ts.params().items()}
    out = t_project(ts.with_params(leaves), port_camera(cam))
    loss = sum((getattr(out, f) * torch.tensor(weights[f])).sum() for f in fields)
    loss.backward()
    for k, leaf in leaves.items():
        r = np.asarray(g_ref[k])
        assert np.isfinite(np_(leaf.grad)).all(), k
        np.testing.assert_allclose(
            np_(leaf.grad), r, rtol=1e-5, atol=1e-5 * max(np.abs(r).max(), 1.0), err_msg=k
        )
