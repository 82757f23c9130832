"""`gsattack_torch.train.densify` against `gsattack.train.densify` on the
same scenes: stats, clone, split (the JAX package's normal draws
injected as `noise`), prune, overflow with its dropped count, Adam
moments through the slot allocator, `grow_capacity` and `reset_opacity`.
Slots, `alive` and dropped counts equal; values within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.train import densify as jd
from gsattack_torch.train import densify as td
from tests.conftest import make_toy_scene
from tests.torch_port import np_, port_scene

torch.set_num_threads(2)


def jax_noise(key, c):
    """The split children's draws of the JAX pass, one (C, 3) per wave."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (c, 3)))
                     for i in range(td.N_SPLIT)])


def _stats(c, accum, denom=None, radii=None):
    a = np.asarray(accum, np.float32)
    d = np.ones(c, np.float32) if denom is None else np.asarray(denom, np.float32)
    r = np.zeros(c, np.float32) if radii is None else np.asarray(radii, np.float32)
    return (jd.DensifyStats(jnp.asarray(a), jnp.asarray(d), jnp.asarray(r)),
            td.DensifyStats(torch.tensor(a), torch.tensor(d), torch.tensor(r)))


def _scenario(name):
    """(JAX scene, accum, radii, kwargs) of one densify case; the first four
    share a capacity of 16, so that the JAX pass compiles once for them."""
    rng = np.random.default_rng(7)
    if name == "clone":
        sc = make_toy_scene(n=8).pad_to(16)
        sc = sc.replace(log_scale=jnp.full_like(sc.log_scale, -10.0))
        accum = np.zeros(16)
        accum[[0, 3]] = 10.0
        return sc, accum, None, dict(max_grad=1.0, extent=1.0)
    if name == "split":
        sc = make_toy_scene(n=8).pad_to(16)
        sc = sc.replace(log_scale=jnp.full_like(sc.log_scale, 2.0))
        accum = np.zeros(16)
        accum[1] = 10.0
        return sc, accum, None, dict(max_grad=1.0, extent=1.0, percent_dense=0.01)
    if name == "prune":
        sc = make_toy_scene(n=8).pad_to(16)
        sc = sc.replace(opacity_logit=jnp.full((16, 1), -10.0).at[0, 0].set(2.0).at[1, 0].set(2.0))
        return sc, np.zeros(16), None, {}
    if name == "overflow":
        sc = make_toy_scene(n=16)
        sc = sc.replace(log_scale=jnp.full_like(sc.log_scale, -10.0))
        return sc, np.full(16, 10.0), None, dict(max_grad=1.0)
    # mixed: clones, splits and prunes at once, more children than free
    # slots, and the screen-size limit
    sc = make_toy_scene(n=40, seed=3).pad_to(48)
    ls = np.asarray(sc.log_scale).copy()
    ls[::2] = -8.0  # small: clone
    sc = sc.replace(log_scale=jnp.asarray(ls),
                    opacity_logit=sc.opacity_logit.at[5, 0].set(-9.0).at[17, 0].set(-9.0))
    accum = rng.uniform(0, 2, size=48) * np.asarray(sc.alive)
    radii = rng.uniform(0, 30, size=48)
    return sc, accum, radii, dict(max_grad=0.8, extent=10.0, percent_dense=0.01,
                                  max_screen_size=25.0, use_screen_limit=True)


@pytest.mark.parametrize("name", ["clone", "split", "prune", "overflow", "mixed"])
def test_densify_and_prune_matches(name):
    js, accum, radii, kw = _scenario(name)
    with_moments = name != "prune"
    c = js.num_points
    jstats, tstats = _stats(c, accum, radii=radii)
    key = jax.random.PRNGKey(1)
    jm = tm = None
    if with_moments:
        rng = np.random.default_rng(2)
        mom = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in js.params().items()}
               for _ in range(2)]
        jm = tuple({k: jnp.asarray(v) for k, v in m.items()} for m in mom)
        tm = tuple({k: torch.tensor(v) for k, v in m.items()} for m in mom)
    jout, jst, jdrop, jmom = jd.densify_and_prune(js, jstats, key, moments=jm, **kw)
    tout, tst, tdrop, tmom = td.densify_and_prune(port_scene(js), tstats, moments=tm,
                                                  noise=torch.tensor(jax_noise(key, c)), **kw)
    assert tdrop == int(jdrop)
    np.testing.assert_array_equal(np_(tout.alive), np.asarray(jout.alive))
    for k, v in jout.params().items():
        np.testing.assert_allclose(np_(tout.params()[k]), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    if with_moments:
        for tmi, jmi in zip(tmom, jmom):
            for k, v in jmi.items():
                np.testing.assert_allclose(np_(tmi[k]), np.asarray(v), rtol=0, atol=1e-6,
                                           err_msg=k)
    if name == "overflow":
        assert tdrop == 16
    if name == "mixed":
        assert tdrop > 0 and int(tout.alive.sum()) == c


def test_densification_stats_match():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(32, 2)).astype(np.float32)
    radii = rng.integers(-1, 5, size=32).astype(np.int32)
    jstats, tstats = _stats(32, rng.uniform(size=32), rng.uniform(size=32), rng.uniform(size=32))
    want = jd.add_densification_stats(jstats, jnp.asarray(g), jnp.asarray(radii))
    got = td.add_densification_stats(tstats, torch.tensor(g), torch.tensor(radii))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("round_to", [1, 8])
def test_grow_capacity_matches(round_to):
    js = make_toy_scene(n=20, seed=2).pad_to(24)
    rng = np.random.default_rng(3)
    jstats, tstats = _stats(24, rng.uniform(size=24), rng.uniform(size=24), rng.uniform(size=24))
    mom = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in js.params().items()}
    jsc, jst, (jm,) = jd.grow_capacity(js, jstats, 1.5, moments=({k: jnp.asarray(v) for k, v in
                                                                  mom.items()},),
                                       round_to=round_to)
    tsc, tst, (tm,) = td.grow_capacity(port_scene(js), tstats, 1.5,
                                       moments=({k: torch.tensor(v) for k, v in mom.items()},),
                                       round_to=round_to)
    assert tsc.num_points == jsc.num_points
    np.testing.assert_array_equal(np_(tsc.alive), np.asarray(jsc.alive))
    for k, v in jsc.params().items():
        np.testing.assert_array_equal(np_(tsc.params()[k]), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(np_(tm[k]), np.asarray(jm[k]), err_msg=k)
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    tsc2, tst2 = td.grow_capacity(port_scene(js), tstats, 1.5, round_to=round_to)
    assert tsc2.num_points == jsc.num_points and tst2.max_radii2d.shape == (jsc.num_points,)


def test_reset_opacity_matches():
    js = make_toy_scene(n=16, seed=4)
    js = js.replace(opacity_logit=js.opacity_logit.at[0, 0].set(-8.0))
    want = jd.reset_opacity(js).opacity_logit
    got = td.reset_opacity(port_scene(js)).opacity_logit
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_split_draws_come_from_the_generator():
    js, accum, _, kw = _scenario("split")
    _, tstats = _stats(16, accum)
    a = td.densify_and_prune(port_scene(js), tstats, torch.Generator().manual_seed(3), **kw)[0]
    b = td.densify_and_prune(port_scene(js), tstats, torch.Generator().manual_seed(3), **kw)[0]
    c = td.densify_and_prune(port_scene(js), tstats, torch.Generator().manual_seed(4), **kw)[0]
    assert torch.equal(a.xyz, b.xyz) and not torch.equal(a.xyz, c.xyz)
    with pytest.raises(ValueError, match="noise of shape"):
        td.densify_and_prune(port_scene(js), tstats, noise=torch.zeros(2, 15, 3), **kw)
