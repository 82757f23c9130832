"""`gsattack_torch.parallel` against `gsattack.parallel` and the unsharded
port: the mesh shape, the band planner and its pair costs directly, then
two spawned gloo groups on the CPU (`tests/torch_parallel_ranks.py`).

The (2, 2) group of 4 ranks renders `make_toy_scene(n=64)` sharded at
48x64 (4 tile rows for 2 bands) in each of `RENDER_CASES` (even, uneven
and measured bands, an odd height, an indivisible splat count, an
indivisible view batch, a blend replicated over splats), and runs DAGGER.
Images agree with the unsharded port within 1e-5 abs, gradients within
2e-6 times the largest; against JAX's unsharded `render_views`, images
1e-5 abs and gradients 1e-3 max rel. `run_dagger(mesh)` matches
`run_dagger()` (losses rtol 1e-4, f_dc atol 1e-5, as JAX's
`test_dagger_with_mesh`). The (1, 2) group of 2 ranks trains through two
densify passes that grow the capacity, runs CLOAK and the command line's
`attack` with `use_mesh=true`. Each rank runs one thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.attack.dagger import render_views as j_render_views
from gsattack.cli import _mesh_from_cfg as j_mesh_from_cfg
from gsattack.core.camera import stack_cameras as j_stack
from gsattack.ops.project import project as j_project
from gsattack.parallel import local_mesh_shape as j_local_mesh_shape
from gsattack.parallel.pallas_shard import measure_tile_row_costs as j_costs
from gsattack.parallel.pallas_shard import plan_bands as j_plan_bands
from gsattack.utils.config import load_config as j_load_config
from gsattack_torch.cli import mesh_shape_from_cfg
from gsattack_torch.core.camera import stack_cameras
from gsattack_torch.ops.project import project
from gsattack_torch.parallel import (
    initialize_distributed,
    local_mesh_shape,
    measure_tile_row_costs,
    plan_bands,
    run_local,
)
from gsattack_torch.render import render as t_render
from gsattack_torch.utils.config import load_config
from tests import torch_parallel_ranks as ranks
from tests.conftest import make_toy_camera, make_toy_scene
from tests.torch_port import max_rel_err, np_, port_camera, port_scene

torch.set_num_threads(2)

GATE_IMAGE = 1e-5
GATE_GRAD_PORT = 2e-6  # times the largest gradient
GATE_GRAD_JAX = 1e-3  # max rel
JAX_CASES = ("rgb", "odd_height")


def _cams(n_views, width, height):
    return [make_toy_camera(width=width, height=height, z=0.1 * i) for i in range(n_views)]


def _gts(cams, n=48, seed=5):
    target = port_scene(make_toy_scene(n=n, seed=seed))
    with torch.no_grad():
        return [np_(t_render(target, c, torch.zeros(3))["render"]) for c in cams]


@pytest.fixture(scope="module")
def inputs():
    """Every input of both groups, made once in this process from the JAX
    package's toy scenes and cameras."""
    scenes = {n: port_scene(make_toy_scene(n=n, seed=3)) for n in (63, 64)}
    cams = {case: stack_cameras([port_camera(c) for c in _cams(v, w, h)])
            for case, (_, v, w, h, *_) in ranks.RENDER_CASES.items()}
    mask = np.random.default_rng(1).uniform(size=64) > 0.3
    dagger = (port_scene(make_toy_scene(n=64, seed=0)), port_scene(make_toy_scene(n=16, seed=1)),
              mask)
    train_cams = [port_camera(c) for c in _cams(3, 32, 48)]
    rng = np.random.default_rng(0)
    classifier = (rng.normal(size=(8, 16)).astype(np.float32), rng.normal(size=8).astype(np.float32))
    train = (port_scene(make_toy_scene(n=64, seed=0)), train_cams, _gts(train_cams), classifier)
    cloak_cams = [port_camera(c) for c in _cams(2, 48, 48)]
    cloak = (port_scene(make_toy_scene(n=32, seed=10)), cloak_cams, _gts(cloak_cams))
    return {"scenes": scenes, "cams": cams, "dagger": dagger, "train": train, "cloak": cloak}


@pytest.fixture(scope="module")
def group4(inputs):
    return run_local(ranks.group_2x2, 4, args=(inputs["scenes"], inputs["cams"], inputs["dagger"]),
                     device="cpu", timeout=300)


@pytest.fixture(scope="module")
def group2(inputs, tmp_path_factory):
    return run_local(ranks.group_1x2, 2, args=(inputs["train"], inputs["cloak"],
                                               str(tmp_path_factory.mktemp("cli_mesh"))),
                     device="cpu", timeout=300)


# ---- the mesh shape, the band planner and its costs, directly -----------


def test_local_mesh_shape_matches_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        for views in (None, 1, n):
            assert local_mesh_shape(n, views) == j_local_mesh_shape(n, views), (n, views)
    with pytest.raises(ValueError, match="not divisible"):
        local_mesh_shape(6, views=4)


@pytest.mark.parametrize("rows,bands,seed", [(8, 4, 0), (50, 8, 1), (13, 3, 2), (40, 5, 3),
                                             (7, 3, None), (9, 9, 4), (5, 1, 5)])
def test_plan_bands_matches_jax(rows, bands, seed):
    costs = (np.ones(rows) if seed is None
             else np.random.default_rng(seed).integers(0, 500, rows).astype(np.float64))
    plan = plan_bands(costs, bands)
    assert plan == j_plan_bands(costs, bands)
    assert len(plan) == bands and sum(plan) == rows and min(plan) >= 1
    assert plan_bands(np.zeros(rows), bands) == j_plan_bands(np.zeros(rows), bands)


def test_plan_bands_refuses_more_bands_than_rows():
    for plan in (plan_bands, j_plan_bands):
        with pytest.raises(ValueError, match="4 bands over 3"):
            plan(np.ones(3), 4)


def test_measure_tile_row_costs_matches_jax():
    js = make_toy_scene(n=64, seed=3)
    cam = make_toy_camera(width=48, height=72, z=0.1)
    want = j_costs(j_project(js, cam), 48, 72)
    got = measure_tile_row_costs(project(port_scene(js), port_camera(cam)), 48, 72)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5,) and got.sum() > 0


def test_band_binning_is_the_whole_image_binning_of_its_rows():
    """A band binned with `tile_rows` lists each of its tiles' gaussians as
    the whole image's binning does, in the same order: the same candidate
    tiles under the pairs-per-gaussian cap, and depth ties at the whole
    image's key precision. Binned on its own smaller grid (the means moved
    up), the cap keeps other tiles and the keys get more depth bits."""
    from gsattack_torch.ops.raster import bin_gaussians

    rng = np.random.default_rng(0)
    n, size, (r0, r1) = 400, 512, (10, 26)  # 32 x 32 tiles; the band is rows 10-25
    mean2d = torch.tensor(rng.uniform(0, size, (n, 2)), dtype=torch.float32)
    # Depths a third of the whole image's depth step apart: ties at its
    # precision, not all at the band grid's.
    depth = torch.tensor(3.0 + rng.integers(0, 60, n) * 3e-6, dtype=torch.float32)
    radius = torch.tensor(rng.uniform(8, 60, n), dtype=torch.float32)

    def lists(bins, tiles):
        return [bins.gauss_idx[bins.tile_start[t]:bins.tile_end[t]].tolist() for t in tiles]

    band = range((r1 - r0) * 32)
    whole = lists(bin_gaussians(mean2d, depth, radius, size, size, 6), range(r0 * 32, r1 * 32))
    rows = lists(bin_gaussians(mean2d, depth, radius, size, size, 6, tile_rows=(r0, r1)), band)
    shifted = mean2d - torch.tensor([0.0, r0 * 16.0])
    own = lists(bin_gaussians(shifted, depth, radius, size, (r1 - r0) * 16, 6), band)
    assert rows == whole and own != whole


def test_initialize_distributed_validation():
    with pytest.raises(ValueError, match="given together"):
        initialize_distributed("gloo", init_method="tcp://127.0.0.1:1234", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        initialize_distributed("gloo", "tcp://127.0.0.1:1234", 2, 5, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        initialize_distributed("mpi", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        initialize_distributed("nccl", device="cpu")


def test_run_local_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_local(ranks.group_1x2, 2)


@pytest.mark.parametrize("overrides,hint", [
    (["use_mesh=false"], 4),
    (["use_mesh=true"], 1),
    (["use_mesh=true", "batch_size=4"], 4),
    (["use_mesh=true", "batch_size=5"], 5),
    (["use_mesh=true", "batch_size=2"], 2),
    (["use_mesh=true", "mesh_shape=[2,4]"], 4),
    (["use_mesh=true", "mesh_shape=[1,8]"], 2),
])
def test_mesh_shape_from_cfg_matches_jax(overrides, hint):
    """`use_mesh` / `mesh_shape` from configs/config.yaml with overrides:
    the port's shape is the one JAX's `_mesh_from_cfg` builds on the 8
    virtual CPU devices."""
    jmesh = j_mesh_from_cfg(j_load_config("configs", overrides=overrides), "t", views_hint=hint)
    got = mesh_shape_from_cfg(load_config("configs", overrides=overrides), 8, views_hint=hint)
    assert got == (None if jmesh is None else tuple(jmesh.devices.shape))


# ---- the (2, 2) group ---------------------------------------------------


def test_group_joins(group4):
    for r, res in enumerate(group4):
        want = {"distributed": True, "process_id": r, "num_processes": 4, "devices": 4,
                "local_devices": 1, "local_rank": r, "backend": "gloo"}
        assert res["info"] == res["joined_again"] == want


def _unsharded(inputs, case):
    n = ranks.RENDER_CASES[case][0]
    return ranks.render_case(inputs["scenes"][n], inputs["cams"][case], case)


def _jax_render(case):
    n, v, w, h, *_ = ranks.RENDER_CASES[case]
    js, cams = make_toy_scene(n=n, seed=3), j_stack(_cams(v, w, h))

    def loss(params):
        img = j_render_views(js.with_params(params), cams, jnp.zeros(3))
        return jnp.mean(img ** 2), img

    (_, img), grads = jax.value_and_grad(loss, has_aux=True)(js.params())
    return np.asarray(img), {k: np.asarray(g) for k, g in grads.items()}


@pytest.mark.parametrize("case", list(ranks.RENDER_CASES))
def test_sharded_render_matches(group4, inputs, case):
    want_img, want_grads = _unsharded(inputs, case)
    n, v, w, h, _, objects, _ = ranks.RENDER_CASES[case]
    assert want_img.shape == (v, h, w, 19 if objects else 3)
    for r, res in enumerate(group4):
        img, grads = res[case]
        assert img.shape == want_img.shape, r
        assert np.abs(img - want_img).max() <= GATE_IMAGE, (r, np.abs(img - want_img).max())
        for k, g in want_grads.items():
            scale = max(np.abs(g).max(), 1e-12)
            assert np.abs(grads[k] - g).max() <= GATE_GRAD_PORT * scale, (r, k)
        # Every rank holds the same batch and the same whole gradient.
        assert np.array_equal(img, group4[0][case][0])
    if case in JAX_CASES:
        jimg, jgrads = _jax_render(case)
        img, grads = group4[0][case]
        assert np.abs(img - jimg).max() <= GATE_IMAGE
        for k, g in jgrads.items():
            assert max_rel_err(grads[k], g) <= GATE_GRAD_JAX, k


def test_sharded_truncation_count_matches(group4, inputs):
    want = ranks.truncated_pairs(inputs["scenes"][64], inputs["cams"]["rgb"])
    assert want > 0
    assert [res["truncated"] for res in group4] == [want] * 4


@pytest.mark.parametrize("case", list(ranks.DAGGER_CASES))
def test_dagger_with_mesh(group4, inputs, case):
    losses, f_dc, success, lines = ranks.dagger_case(*inputs["dagger"], case)
    got_losses, got_f_dc, got_success, got_lines = group4[0][case]
    assert len(losses) == 2  # the third iteration ends the batch
    np.testing.assert_allclose(got_losses, losses, rtol=1e-4)
    np.testing.assert_allclose(got_f_dc, f_dc, atol=1e-5)
    assert got_success == success
    assert "[Info] Pair-balanced tile bands: (2, 2)" in got_lines
    assert ("[Info] The view batch of 3 does not divide the views axis (2): views "
            "replicated, splats still sharded." in got_lines) == (case == "dagger_replicated_views")
    assert any(ln.startswith("[Info] Auto-sized") for ln in lines) == (case == "dagger_auto_caps")
    assert [ln for ln in got_lines if "tile bands" not in ln and "view batch" not in ln] == lines
    for res in group4[1:]:
        assert res[case][3] == []  # only rank 0 logs
        np.testing.assert_array_equal(res[case][1], got_f_dc)


# ---- the (1, 2) group ---------------------------------------------------


def test_trainer_with_mesh(group2, inputs):
    losses, state = ranks.train_case(*inputs["train"])
    assert state["scene.xyz"].shape[0] > 96  # a densify pass grew the capacity
    for res in group2:
        got_losses, got_state = res["train"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        assert got_state.keys() == state.keys()
        np.testing.assert_array_equal(got_state["scene.alive"], state["scene.alive"])
        for k, v in state.items():
            assert got_state[k].shape == v.shape, k
            if k != "scene.alive":
                assert max_rel_err(got_state[k], v) <= 1e-3, k


def test_run_cloak_with_mesh(group2, inputs):
    f_dc, xyz, poisoned = ranks.cloak_case(*inputs["cloak"])
    for res in group2:
        got_f_dc, got_xyz, got_poisoned = res["cloak"]
        np.testing.assert_array_equal(got_poisoned, poisoned)
        assert max_rel_err(got_f_dc, f_dc) <= 1e-4 and max_rel_err(got_xyz, xyz) <= 1e-4


def test_cli_attack_use_mesh(group2, tmp_path):
    rc, out = ranks.cli_attack(str(tmp_path), mesh=False)
    got_rc, got_out = group2[0]["cli"]
    assert got_rc == rc and group2[1]["cli"] == (rc, "")  # only rank 0 prints

    def final_loss(text):
        return float(text.split("final_loss=")[1].split()[0])

    assert "attack finished" in got_out
    np.testing.assert_allclose(final_loss(got_out), final_loss(out), rtol=1e-4)
