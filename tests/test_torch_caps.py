"""The static caps of `gsattack_torch.ops.raster` against `gsattack.ops.raster`
on the CPU: the `auto_*` probes' integers, the tiered bin, `render` on the
"pallas" route under a binding `pairs_budget` and a binding
`compact_budget` (the reference's Pallas kernels in interpret mode, one
call each), the slot-table backward against the per-gaussian autograd it
replaces, `gather_sum_rows`'s plain version on its edge cases, and the
sizes `run_dagger` gives every cap at -1.

Every comparison feeds both packages the same projected inputs (the JAX
projection carried across), so the integers must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.attack import AttackConfig as JConfig
from gsattack.attack import run_dagger as j_run_dagger
from gsattack.ops import raster as jr
from gsattack.ops.project import project as j_project
from gsattack_torch.attack import AttackConfig as TConfig
from gsattack_torch.attack import run_dagger as t_run_dagger
from gsattack_torch.core.camera import CameraExtrinsics as TExtrinsics
from gsattack_torch.ops import raster as tr
from gsattack_torch.ops.gather_sum import gather_sum_rows, gather_sum_rows_plain
from gsattack_torch.ops.project import ProjectedGaussians
from tests.conftest import make_toy_camera, make_toy_scene
from tests.test_attack import _toy_views
from tests.test_torch_dagger import _toy_pair
from tests.torch_port import max_rel_err, np_, port_scene

torch.set_num_threads(2)

# (splats, image side, log-scale change of every 6th splat, of the rest):
# the toy scene, and one where a sixth of the splats are large and
# anisotropic and the rest small, so that a few heavy gaussians cover up to
# 16 tiles each (the tier pays at a small quantum; the budgets bind).
SCENES = {"toy": (48, 32, 0.0, 0.0), "large": (96, 64, 1.2, -0.6)}


def _scene(name):
    n, size, big, small = SCENES[name]
    js = make_toy_scene(n=n, seed=1)
    boost = np.where(np.arange(n) % 6 == 0, big, small).astype(np.float32)[:, None]
    return js.replace(log_scale=js.log_scale + boost), size


def _projected(name):
    """The JAX projection of a scene and the same values as the port's
    ProjectedGaussians, and the image side."""
    js, size = _scene(name)
    jp = j_project(js, make_toy_camera(size, size))
    tp = ProjectedGaussians(*(torch.tensor(np.asarray(f)) for f in jp))
    return jp, tp, size


@pytest.mark.parametrize("name", list(SCENES))
def test_probes_match_jax(name):
    jp, tp, s = _projected(name)
    assert tr.auto_pairs_per_gaussian(tp, s, s) == jr.auto_pairs_per_gaussian(jp, s, s)
    pairs, rect = tr.auto_pair_caps(tp, s, s)
    assert (pairs, rect) == jr.auto_pair_caps(jp, s, s)
    for p, r in ((pairs, rect), (pairs, 0), (rect, 0)):
        for margin in (1.0, 1.25):
            assert (tr.auto_pairs_budget(tp, s, s, p, margin, r)
                    == jr.auto_pairs_budget(jp, s, s, p, margin, r))
            assert (tr.auto_compact_budget(tp, s, s, p, margin, r)
                    == jr.auto_compact_budget(jp, s, s, p, margin, r))
    # The default quantum (1024) keeps a small scene's tier off; a small
    # one lets the split search pick a split (on the large scene).
    for quantum in (1024, 8):
        tier = tr.auto_tier_caps(tp, s, s, pairs, rect, quantum=quantum)
        assert tier == jr.auto_tier_caps(jp, s, s, pairs, rect, quantum=quantum)
        assert (tier[0] > 0) == (name == "large" and quantum == 8)
        for split in (1, 2):
            assert (tr.auto_heavy_budget(tp, s, s, pairs, rect, split, quantum=quantum)
                    == jr.auto_heavy_budget(jp, s, s, pairs, rect, split, quantum=quantum))
    assert tr.auto_caps(tp, s, s) == jr.auto_caps(jp, s, s)
    # Slab by slab, a few splats at a time, as in one slab.
    counts, hist = tr._probe_pair_stats(tp, s, s, pairs, rect, slab=7)
    want = jr._probe_pair_stats(jp, s, s, pairs, rect)
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(hist, want[1])


def _tile_sets(gauss_idx, start, end):
    g = np.asarray(gauss_idx)
    return [sorted(g[a:b].tolist()) for a, b in zip(np.asarray(start), np.asarray(end))]


@pytest.mark.parametrize("name,split,heavy", [("toy", 2, 8), ("large", 4, 16)])
def test_tiered_bin_matches_jax(name, split, heavy):
    """A heavy_budget that binds: the same gaussians in every tile (as sets:
    depth ties may order them otherwise) and the same culled count; the
    slot table names each kept pair once."""
    jp, tp, s = _projected(name)
    pairs, rect = jr.auto_pair_caps(jp, s, s)
    tier = dict(tier_split=split, heavy_budget=heavy)
    ref = jax.jit(lambda p: jr.bin_gaussians(
        p.mean2d, p.depth, p.radius_tight, s, s, pairs, conic=p.conic, opacity=p.opacity,
        rect_candidates=rect, **tier))(jp)

    def port_bins(**kw):
        return tr.bin_gaussians(tp.mean2d, tp.depth, tp.radius_tight, s, s, pairs,
                                conic=tp.conic, opacity=tp.opacity, rect_candidates=rect, **kw)

    got, untiered = port_bins(**tier), port_bins()
    assert _tile_sets(got.gauss_idx, got.tile_start, got.tile_end) == _tile_sets(
        ref.gauss_idx, ref.tile_start, ref.tile_end)
    assert int(got.num_culled_pairs) == int(ref.num_culled_pairs)
    assert int(got.num_culled_pairs) > int(untiered.num_culled_pairs)  # the tier binds
    named = got.slot_table[got.slot_table >= 0].long()
    assert torch.equal(torch.sort(named).values, torch.arange(got.gauss_idx.shape[0]))
    rows = torch.arange(got.slot_table.shape[0])[:, None].expand_as(got.slot_table)
    assert torch.equal(got.gauss_idx[named].long(), rows[got.slot_table >= 0])


def _weights(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("budget", [dict(pairs_budget=256), dict(compact_budget=128)])
def test_render_pallas_budget_matches_jax(budget):
    """The toy scene (180 pairs over 4 tiles) on the "pallas" route under a
    budget that binds: images, the gradients of every projected field but
    the binning radius, and num_truncated_pairs against the reference's
    Pallas kernels in interpret mode."""
    jp, tp, s = _projected("toy")
    pairs = jr.auto_pairs_per_gaussian(jp, s, s)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    w_img, w_obj, w_t = (_weights(sh, i) for i, sh in
                         enumerate(((s, s, 3), (s, s, 16), (s, s))))
    fields = ("mean2d", "conic", "opacity", "color", "obj")

    def j_loss(diff):
        p = jp._replace(**diff)
        out = jr.rasterize(p, s, s, jnp.asarray(bg), pairs, backend="pallas",
                           interpret=True, **budget)
        loss = ((out["render"] * w_img).sum() + (out["render_object"] * w_obj).sum()
                + (out["final_transmittance"] * w_t).sum())
        return loss, out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {k: getattr(jp, k) for k in fields})
    leaves = {k: getattr(tp, k).clone().requires_grad_(True) for k in fields}
    t_out = tr.rasterize(tp._replace(**leaves), s, s, torch.tensor(bg), pairs, backend="pallas",
                         **budget)
    loss = ((t_out["render"] * torch.tensor(w_img)).sum()
            + (t_out["render_object"] * torch.tensor(w_obj)).sum()
            + (t_out["final_transmittance"] * torch.tensor(w_t)).sum())
    t_grads = dict(zip(fields, torch.autograd.grad(loss, list(leaves.values()))))
    for k in ("render", "render_object", "final_transmittance"):
        np.testing.assert_allclose(np_(t_out[k]), np.asarray(j_out[k]), atol=1e-5, err_msg=k)
    for k in fields:
        assert max_rel_err(np_(t_grads[k]), np.asarray(j_grads[k])) <= 1e-3, k
    truncated = int(t_out["num_truncated_pairs"])
    assert truncated == int(j_out["num_truncated_pairs"]) and truncated > 0


def _old_route(rows, gauss_idx, slot_table):
    """The plain blend's backward before the slot table: autograd of the
    per-gaussian gather itself."""
    return rows[gauss_idx.long()]


def test_slot_table_reduction_matches_autograd(monkeypatch):
    """The plain blend's gradients summed over the slot table against the
    per-gaussian autograd route to 1e-6, and the same bit for bit on a
    second call."""
    _, tp, s = _projected("large")
    views = ProjectedGaussians(*(f[None] for f in tp))
    bins = tr.bin_views(views, s, s, 16)
    tiles = tr._tiles(s, s)
    chans = torch.cat([views.color, views.obj], -1)
    inputs = [x.clone().requires_grad_(True)
              for x in (views.mean2d, views.conic, views.opacity, chans)]
    idx = (bins.gauss_idx, bins.tile_start, bins.tile_end)
    w = torch.tensor(_weights((1, s, s, 19), 5))

    def grads():
        img, T = tr.blend_tiles_plain(*idx, *inputs, *tiles, 64, 16, bins.slot_table)
        return torch.autograd.grad((img * w).sum() + T.sum(), inputs)

    first, second = grads(), grads()
    monkeypatch.setattr(tr._PairRows, "apply", _old_route)
    ref = grads()
    for a, b, r in zip(first, second, ref):
        assert torch.equal(a, b)
        assert max_rel_err(np_(a), np_(r)) <= 1e-6


def _gather_sum_reference(rows, table):
    out = np.zeros((table.shape[0], rows.shape[1]), np.float32)
    for g in range(table.shape[0]):
        for r in table[g]:
            if r >= 0:
                out[g] += rows[r]
    return out


@pytest.mark.parametrize("w", [9, 25])
def test_gather_sum_rows_edge_cases(w):
    """c = 1, a row of -1 only, no gaussians, repeated slots, no pairs: the
    plain version against a loop, and the CPU route is the plain version."""
    rng = np.random.default_rng(w)
    rows = rng.normal(size=(40, w)).astype(np.float32)
    cases = {
        "c=1": rng.integers(-1, 40, size=(17, 1)),
        "all -1 row": np.concatenate([rng.integers(-1, 40, size=(5, 4)),
                                      np.full((1, 4), -1)]),
        "n=0": np.zeros((0, 3)),
        "repeated slots": np.array([[3, 3, 3, -1], [7, -1, 7, 7], [0, 1, 0, 1]]),
    }
    for name, table in cases.items():
        t = torch.tensor(table, dtype=torch.int32)
        got = gather_sum_rows(torch.tensor(rows), t)
        assert torch.equal(got, gather_sum_rows_plain(torch.tensor(rows), t)), name
        np.testing.assert_allclose(np_(got), _gather_sum_reference(rows, table), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    empty = gather_sum_rows(torch.zeros((0, w)), torch.full((3, 2), -1, dtype=torch.int32))
    assert torch.equal(empty, torch.zeros((3, w)))
    with pytest.raises(ValueError, match="int32"):
        gather_sum_rows(torch.tensor(rows), torch.zeros((2, 2), dtype=torch.int64))


def test_run_dagger_auto_caps_match_jax(tmp_path):
    """Every cap at -1: the port's run_dagger sizes what the reference's
    logs (max_iters=1: set-up and the benign render, no PGD step)."""
    js, s = _scene("large")
    jdet, tdet = _toy_pair()
    views = _toy_views(1, s, s)
    kw = dict(max_iters=1, batch_size=1, target=2, output_dir=str(tmp_path), save_ply=False,
              pairs_per_gaussian=-1, rect_candidates=-1, pairs_budget=-1, compact_budget=-1,
              tier_split=-1, heavy_budget=-1)
    logs = {"j": [], "t": []}
    j_run_dagger(js, views, jdet, JConfig(**kw), log=logs["j"].append)
    tviews = [TExtrinsics(v.R, v.T, v.fovx, v.fovy, v.width, v.height, uid=v.uid) for v in views]
    t_run_dagger(port_scene(js), tviews, tdet, TConfig(**kw), log=logs["t"].append)
    sized = {k: [line for line in v if line.startswith("[Info] Auto-sized")]
             for k, v in logs.items()}
    assert sized["t"] == sized["j"] and len(sized["t"]) >= 3


def test_trainer_sizes_caps_at_fit():
    """A Trainer with every cap at -1 sizes them at `fit` from its scene
    over the training views, as `resolve_caps` does, and trains."""
    from gsattack_torch.ops.project import project
    from gsattack_torch.train import TrainConfig, Trainer
    from tests.test_torch_train import _toy_problem
    from tests.torch_port import port_camera

    cams, gts, _ = _toy_problem()
    cams = [port_camera(c) for c in cams]
    js, _ = _scene("large")
    auto = dict(pairs_per_gaussian=-1, rect_candidates=-1, pairs_budget=-1, compact_budget=-1,
                tier_split=-1, heavy_budget=-1)
    trainer = Trainer(port_scene(js), TrainConfig(backend="pallas", **auto), device="cpu")
    scene = trainer.full_state().scene
    with torch.no_grad():
        want = tr.resolve_caps([(project(scene, c), c.width, c.height) for c in cams],
                               *auto.values(), log=lambda *_: None)
    losses = []
    trainer.fit(cams, gts, iterations=2, log=lambda i, l: losses.append(l))
    assert {k: getattr(trainer.cfg, k) for k in want} == want
    assert want["pairs_budget"] > 0 and want["compact_budget"] > 0
    assert len(losses) == 2 and np.isfinite(losses).all()
