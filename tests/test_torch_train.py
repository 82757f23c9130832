"""`gsattack_torch.train` against `gsattack.train`: the `Trainer` from one
state (`convert.train_state_from_jax`) on `make_toy_scene(n=48)` at 32x32,
3 cameras in a fixed view order, 6 steps with the grouping regulariser
on (the JAX draws injected) and densify/prune at steps 3 and 5 (the
second one grows the capacity): losses rtol 1e-4, final parameters and
Adam moments 1e-3 max rel, `alive` equal. Also `reg3d_loss` (1e-5),
checkpoints (save, restore equal, resume) and the trainer's refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.train import TrainConfig as JConfig
from gsattack.train import Trainer as JTrainer
from gsattack.train.reg3d import reg3d_loss as j_reg3d
from gsattack_torch.convert import train_state_from_jax
from gsattack_torch.io import checkpoint as ckpt
from gsattack_torch.render import render as t_render
from gsattack_torch.train import TrainConfig as TConfig
from gsattack_torch.train import Trainer as TTrainer
from gsattack_torch.train.reg3d import reg3d_loss as t_reg3d
from tests.conftest import make_toy_camera, make_toy_scene
from tests.test_torch_densify import jax_noise
from tests.torch_port import max_rel_err, np_, port_camera, port_scene

torch.set_num_threads(2)

REG3D_SAMPLE = 20
VIEW_ORDER = (0, 1, 2, 1, 0, 2)
DENSIFY_AT = (3, 5)


def _toy_problem():
    """Three JAX cameras, and GT renders of a target scene (by the port's
    plain render: the images are only inputs, the same on both sides)."""
    target = port_scene(make_toy_scene(n=48, seed=5))
    cams = [make_toy_camera(width=32, height=32, z=0.15 * i) for i in range(3)]
    with torch.no_grad():
        gts = [np_(t_render(target, port_camera(c), torch.zeros(3))["render"]) for c in cams]
    rng = np.random.default_rng(0)
    classifier = (rng.normal(size=(8, 16)).astype(np.float32),
                  rng.normal(size=8).astype(np.float32))
    return cams, gts, classifier


def _jax_reg3d_idx(step, n):
    """The JAX trainer's reg3d sample at a step."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    return np.asarray(jax.random.choice(key, n, (min(REG3D_SAMPLE, n),), replace=False))


def _threshold(stats, alive):
    """A densify threshold in the widest gap of the middle third of the
    averaged gradients, so that no point sits at the threshold."""
    g = np.asarray(stats.xyz_gradient_accum) / np.maximum(np.asarray(stats.denom), 1.0)
    g = np.sort(g[np.asarray(alive)])
    lo, hi = len(g) // 3, 2 * len(g) // 3
    i = lo + int(np.argmax(np.diff(g)[lo:hi]))
    return float((g[i] + g[i + 1]) / 2)


def test_trainer_matches_the_jax_trainer_through_two_densify_passes():
    cams, gts, classifier = _toy_problem()
    kw = dict(densify_from_iter=0, densify_until_iter=100, densification_interval=1,
              opacity_reset_interval=10_000, sh_increase_interval=10_000, use_reg3d=True,
              reg3d_interval=2, reg3d_sample_size=REG3D_SAMPLE)
    init = make_toy_scene(n=48, seed=9)
    jt = JTrainer(init, JConfig(**kw), classifier=classifier)
    tt = TTrainer(port_scene(init), TConfig(**kw), classifier=classifier, device="cpu")
    tt.state = train_state_from_jax(jt.state, device="cpu")
    tcams = [port_camera(c) for c in cams]
    capacities = []
    for it, vi in enumerate(VIEW_ORDER, 1):
        step = it - 1
        idx = _jax_reg3d_idx(step, jt.state.scene.num_points) if step % 2 == 0 else None
        want = jt.train_step(cams[vi], jnp.asarray(gts[vi]))
        got = tt.train_step(tcams[vi], torch.tensor(gts[vi]),
                            reg3d_idx=None if idx is None else torch.tensor(idx))
        assert abs(got - want) <= 1e-4 * abs(want), (it, got, want)
        if it in DENSIFY_AT:
            thr = _threshold(jt.state.stats, jt.state.scene.alive)
            jt.cfg.densify_grad_threshold = tt.cfg.densify_grad_threshold = thr
            key = jax.random.PRNGKey(it)
            noise = jax_noise(key, jt.state.scene.num_points)
            jt.maybe_densify(it, key)
            tt.maybe_densify(it, noise=torch.tensor(noise))
            capacities.append(tt.state.scene.num_points)
            assert tt.state.scene.num_points == jt.state.scene.num_points
            np.testing.assert_array_equal(np_(tt.state.scene.alive),
                                          np.asarray(jt.state.scene.alive))
    assert capacities == [72, 108]  # the second pass ran out of slots and grew
    js = jt.state
    assert tt.state.step == int(js.step) == 6 and tt.state.count == int(js.opt_state.count)
    np.testing.assert_array_equal(np_(tt.state.scene.alive), np.asarray(js.scene.alive))
    for k, v in js.scene.params().items():
        assert max_rel_err(tt.state.scene.params()[k], v) <= 1e-3, k
        assert max_rel_err(tt.state.mu[k], js.opt_state.mu[k]) <= 1e-3, k
        assert max_rel_err(tt.state.nu[k], js.opt_state.nu[k]) <= 1e-3, k
    for a, b in zip(tt.state.stats, js.stats):
        assert max_rel_err(a, b) <= 1e-3


def test_train_state_from_jax_carries_every_value():
    js = JTrainer(make_toy_scene(n=12, seed=1), JConfig()).state
    js = js.replace(opt_state=js.opt_state._replace(
        mu={k: v + 1.0 for k, v in js.opt_state.mu.items()}, count=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(5, jnp.int32),
        stats=js.stats._replace(denom=js.stats.denom + 2.0))
    ts = train_state_from_jax(js, device="cpu")
    assert (ts.count, ts.step, ts.scene.active_sh_degree) == (7, 5, 0)
    np.testing.assert_array_equal(np_(ts.scene.alive), np.asarray(js.scene.alive))
    for k, v in js.scene.params().items():
        np.testing.assert_array_equal(np_(ts.scene.params()[k]), np.asarray(v))
        np.testing.assert_array_equal(np_(ts.mu[k]), np.asarray(js.opt_state.mu[k]))
        np.testing.assert_array_equal(np_(ts.nu[k]), np.asarray(js.opt_state.nu[k]))
    for a, b in zip(ts.stats, js.stats):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


@pytest.mark.parametrize("n,sample,max_points", [(60, 25, 300_000), (60, 100, 40)])
def test_reg3d_loss_matches_with_the_sample_injected(n, sample, max_points):
    sc = make_toy_scene(n=n, seed=2)
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 16)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = j_reg3d(sc, jnp.asarray(w), jnp.asarray(b), key, k=5, sample_size=sample,
                   max_points=max_points)
    m = min(n, max_points)
    idx = np.asarray(jax.random.choice(key, m, (min(sample, m),), replace=False))
    ts = port_scene(sc)
    obj = ts.obj_dc.clone().requires_grad_(True)
    got = t_reg3d(ts.replace(obj_dc=obj), torch.tensor(w), torch.tensor(b), k=5,
                  sample_size=sample, max_points=max_points, idx=torch.tensor(idx))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    (g,) = torch.autograd.grad(got, [obj])
    g_want = jax.grad(lambda o: j_reg3d(sc.replace(obj_dc=o), jnp.asarray(w), jnp.asarray(b),
                                        key, k=5, sample_size=sample,
                                        max_points=max_points))(sc.obj_dc)
    assert max_rel_err(g, g_want) <= 1e-5
    drawn = t_reg3d(ts, torch.tensor(w), torch.tensor(b), torch.Generator().manual_seed(0),
                    sample_size=sample, max_points=max_points)
    assert torch.isfinite(drawn) and float(drawn) >= 0


def _port_trainer(**kw):
    cams, gts, _ = _toy_problem()
    cfg = TConfig(densify_from_iter=2, densification_interval=3, densify_until_iter=100,
                  densify_grad_threshold=1e-9, opacity_reset_interval=5, sh_increase_interval=4,
                  capacity_headroom=1.1, **kw)
    return (TTrainer(port_scene(make_toy_scene(n=32, seed=7)), cfg, device="cpu"),
            [port_camera(c) for c in cams], gts)


def _assert_states_equal(a, b):
    fa, fb = a.state_dict(), b.state_dict()
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_saves_restores_and_resumes(tmp_path):
    trainer, cams, gts = _port_trainer()
    losses = []
    trainer.fit(cams, gts, iterations=8, log=lambda i, l: losses.append(l),
                checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert trainer.state.scene.num_points > 35  # densify grew the capacity
    assert trainer.state.scene.active_sh_degree == 2
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_8"]
    assert ckpt.latest_step_dir(str(tmp_path)) == str(tmp_path / "step_8")
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None
    fresh, _, _ = _port_trainer()
    restored = ckpt.restore_checkpoint(str(tmp_path / "step_8"), target=fresh.state)
    _assert_states_equal(restored, trainer.state)
    # Resume from step 4 in a fresh trainer: it runs steps 5..8 again.
    resumed, _, _ = _port_trainer()
    resumed.state = ckpt.restore_checkpoint(str(tmp_path / "step_4"))
    assert resumed.state.step == 4
    resumed.fit(cams, gts, iterations=8)
    assert resumed.state.step == 8 and resumed.state.count == 8
    assert all(bool(torch.isfinite(v).all()) for v in resumed.state.scene.params().values())
    # capture / restore round trip
    back = ckpt.restore(fresh.state, ckpt.capture(trainer.state))
    _assert_states_equal(back, trainer.state)


def test_scene_iteration_convention(tmp_path):
    trainer, _, _ = _port_trainer()
    scene = trainer.state.scene
    for it in (7, 30):
        ckpt.save_scene_iteration(scene, str(tmp_path), it)
    loaded, it = ckpt.load_scene_iteration(str(tmp_path), device="cpu")
    assert it == 30 and loaded.num_points == int(scene.alive.sum())
    assert torch.equal(loaded.xyz, scene.xyz[scene.alive])


# Each static cap at a setting that binds on the toy problem (48 splats at
# 32x32, about 190 pairs over 4 tiles).
BINDING_CAPS = {
    "pairs_budget": dict(pairs_budget=128),
    "compact_budget": dict(compact_budget=64),
    "tier_split": dict(tier_split=1, heavy_budget=4, pairs_per_gaussian=4, rect_candidates=4),
    "heavy_budget": dict(heavy_budget=2, tier_split=2, pairs_per_gaussian=4, rect_candidates=8),
}


@pytest.mark.parametrize("field", ["pairs_budget", "compact_budget", "tier_split",
                                   "heavy_budget"])
def test_trainer_refuses_what_is_not_ported(field, monkeypatch):
    """Each static cap runs in a training step on the "pallas" route, and
    the step's render counts the pairs it drops (more than without it); an
    unknown backend and a missing card are refused."""
    cams, gts, _ = _toy_problem()
    sc = port_scene(make_toy_scene(n=48, seed=5))
    cam = port_camera(cams[0])
    caps = BINDING_CAPS[field]
    trainer = TTrainer(sc, TConfig(backend="pallas", **caps), device="cpu")
    loss, grads, _, out = trainer.loss_and_grads(cam, torch.tensor(gts[0]))
    assert np.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    plain = {k: v for k, v in caps.items() if k in ("pairs_per_gaussian", "rect_candidates")}
    base = t_render(sc, cam, torch.zeros(3), backend="pallas", **plain)

    def drops(o):
        return int(o["num_culled_pairs"]) + int(o["num_truncated_pairs"])

    assert drops(out) > drops(base)
    with pytest.raises(ValueError, match="backend"):
        TTrainer(sc, TConfig(backend="mosaic"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TTrainer(sc, TConfig())
