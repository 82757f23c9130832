"""`gsattack_torch.attack.cloak` against `gsattack.attack.cloak` with the
same toy detector weights: `poison_image` for 3 steps (the first step's
image gradient within 1e-4 max rel; the images within 1e-6 except where
the sign of a near-zero gradient flips, at most 0.1% of the values), and
`run_cloak` end to end at toy size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.attack.cloak import CloakConfig as JCloak
from gsattack.attack.cloak import poison_image as j_poison
from gsattack_torch.attack.cloak import CloakConfig as TCloak
from gsattack_torch.attack.cloak import poison_image as t_poison
from gsattack_torch.attack.cloak import run_cloak
from gsattack_torch.render import render as t_render
from gsattack_torch.train import TrainConfig
from tests.conftest import make_toy_camera, make_toy_scene
from tests.test_torch_dagger import _toy_pair
from tests.torch_port import max_rel_err, np_, port_camera, port_scene

torch.set_num_threads(2)

BBOX = np.array([8, 8, 40, 40], np.float32)


def _views():
    """Two cameras and GT renders of a target scene (by the port's plain
    render: the images are only inputs, the same on both sides)."""
    target = port_scene(make_toy_scene(n=32, seed=8))
    cams = [port_camera(make_toy_camera(width=48, height=48, z=0.1 * i)) for i in range(2)]
    with torch.no_grad():
        return cams, [np_(t_render(target, c, torch.zeros(3))["render"]) for c in cams]


@pytest.mark.parametrize("targeted", [True, False])
def test_poison_image_matches(targeted):
    jdet, tdet = _toy_pair()
    _, gts = _views()
    kw = dict(epsilon=8 / 255, alpha=2 / 255, steps=3, target=2, untarget=2,
              is_targeted=targeted)
    image = gts[0]
    g_want = jax.grad(lambda x: jdet.loss(x[None], 2, jnp.asarray(BBOX)[None]))(
        jnp.asarray(image))
    x = torch.tensor(image, requires_grad=True)
    (g_got,) = torch.autograd.grad(tdet.loss(x[None], 2, BBOX[None]), [x])
    assert max_rel_err(g_got, g_want) <= 1e-4

    want = np.asarray(j_poison(jnp.asarray(image), jdet, BBOX, JCloak(**kw)))
    got = np_(t_poison(torch.tensor(image), tdet, BBOX, TCloak(**kw)))
    flipped = int((np.abs(got - want) > 1e-6).sum())
    print(f"poison_image: {flipped} of {want.size} values differ by more than 1e-6")
    assert flipped <= 1e-3 * want.size
    assert np.abs(got - image).max() <= 8 / 255 + 1e-6
    assert got.min() >= 0.0 and got.max() <= 1.0 and np.abs(got - image).max() > 1e-4


def test_run_cloak_poisons_and_retrains(monkeypatch):
    _, tdet = _toy_pair()
    cams, gts = _views()
    ccfg = TCloak(epsilon=8 / 255, alpha=2 / 255, steps=5, target=2, is_targeted=True,
                  poison_view_indices=(0,))
    tcfg = TrainConfig(densify_from_iter=10_000, sh_increase_interval=10_000,
                       opacity_reset_interval=10_000)
    lines = []
    scene, poisoned = run_cloak(
        port_scene(make_toy_scene(n=32, seed=10)), cams, gts, tdet,
        ccfg, train_cfg=tcfg, iterations=5, log=lines.append, device="cpu",
    )
    assert len(poisoned) == 1 and len(lines) == 2
    delta = np.abs(np_(poisoned[0]) - gts[0])
    assert 1e-4 < delta.max() <= 8 / 255 + 1e-6
    assert all(bool(torch.isfinite(v).all()) for v in scene.params().values())
    # The retraining's render on the "pallas" route with a tiered bin that
    # binds: each step's render counts more dropped pairs than without it.
    from gsattack_torch.train import trainer as ttrainer

    plain_render, seen = ttrainer.render, []

    def counted(sc, cam, bg, **kw):
        out = plain_render(sc, cam, bg, **kw)
        base = plain_render(sc, cam, bg, **{**kw, "tier_split": 0})
        seen.append([int(o["num_culled_pairs"]) + int(o["num_truncated_pairs"])
                     for o in (out, base)])
        return out

    monkeypatch.setattr(ttrainer, "render", counted)
    tiered = dataclasses.replace(tcfg, backend="pallas", tier_split=1, heavy_budget=2,
                                 pairs_per_gaussian=4, rect_candidates=4)
    scene, _ = run_cloak(port_scene(make_toy_scene(n=32, seed=10)), cams, gts, tdet, ccfg,
                         train_cfg=tiered, iterations=2, log=lines.append, device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in scene.params().values())
    assert len(seen) == 2 and all(a > b for a, b in seen)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_cloak(port_scene(make_toy_scene(n=8)), [], [], tdet, ccfg)
