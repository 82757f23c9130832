"""`gsattack_torch.utils.profiling`'s spans and counters inside the port:
the stage spans of a training step and of a PGD iteration under
`torch.profiler`, the spans' cost when nothing records, `pairs_binned`
against the binning, and the launch counters through the registry (the
C entry points stubbed: no card here)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsattack_torch.attack import AttackConfig, run_dagger
from gsattack_torch.core.camera import CameraExtrinsics
from gsattack_torch.core.scene import scene_from_points
from gsattack_torch.models import load_detector
from gsattack_torch.ops import _cuda, blend, gather, gather_sum
from gsattack_torch.ops.project import project, stack_projections
from gsattack_torch.ops.raster import bin_gaussians, bin_views
from gsattack_torch.train import TrainConfig, Trainer
from gsattack_torch.utils import profiling

torch.set_num_threads(2)

STEP_SPANS = {"train/step", "train/loss", "train/backward", "train/adam", "train/stats",
              "train/loss_read", "render/project", "render/bin", "render/blend",
              "blend/gather_sum"}
PGD_SPANS = {"dagger/caps", "dagger/benign", "pgd/iter", "detector/loss", "pgd/backward",
             "pgd/step", "pgd/loss_read", "pgd/eval", "detector/predict", "render/project",
             "render/bin", "render/blend", "blend/gather_sum"}
OUTER = ("train/step", "pgd/iter", "dagger/benign", "dagger/caps")


def _problem(n=48):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)) * 0.5 + np.array([0.0, 0.0, 3.0])
    scene = scene_from_points(pts, rng.uniform(0.05, 0.95, (n, 3)), device="cpu")
    exts = [CameraExtrinsics(np.eye(3), np.array([0.0, 0.0, 0.1 * i]), 1.0, 1.0, 32, 32, uid=i)
            for i in range(2)]
    return scene, exts


def _spans(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _inside(span, outers):
    _, s, e = span
    return any(os <= s and e <= oe for _, os, oe in outers)


def test_a_step_and_an_iteration_open_their_stage_spans(tmp_path):
    scene, exts = _problem()
    cam = exts[0].build(device="cpu")
    trainer = Trainer(scene, TrainConfig(), 1.0, device="cpu")
    gt = torch.rand(32, 32, 3, generator=torch.Generator().manual_seed(1))
    detector = load_detector("toy", num_classes=8, device="cpu")
    cfg = AttackConfig(max_iters=2, batch_size=2, target=2, pairs_per_gaussian=-1,
                       output_dir=str(tmp_path), save_ply=False)
    with profile(activities=[ProfilerActivity.CPU]) as step_prof:
        trainer.train_step(cam, gt)
        trainer.maybe_increase_sh(1)  # acts at multiples of the interval only
        trainer.maybe_increase_sh(trainer.cfg.sh_increase_interval)
        trainer.maybe_reset_opacity(trainer.cfg.opacity_reset_interval)
        trainer.maybe_densify(trainer.cfg.densify_from_iter)
    with profile(activities=[ProfilerActivity.CPU]) as pgd_prof:
        res = run_dagger(scene, exts, detector, cfg, log=lambda *_: None)
    assert len(res.losses) == 1

    step = _spans(step_prof)
    names = [n for n, _, _ in step]
    assert STEP_SPANS | {"train/sh", "train/reset", "train/densify"} == set(names)
    assert names.count("train/step") == names.count("train/sh") == 1
    outers = [s for s in step if s[0] == "train/step"]
    assert all(_inside(s, outers) for s in step if s[0].startswith(("render/", "blend/")))
    assert all(_inside(s, outers) for s in step if s[0].startswith("train/")
               and s[0] not in ("train/sh", "train/reset", "train/densify"))

    pgd = _spans(pgd_prof)
    assert PGD_SPANS == {n for n, _, _ in pgd}
    assert [n for n, _, _ in pgd].count("detector/predict") == 2  # one a view
    iters = [s for s in pgd if s[0] == "pgd/iter"]
    assert all(_inside(s, [x for x in pgd if x[0] in OUTER]) for s in pgd
               if s[0].startswith(("render/", "blend/")))
    assert any(_inside(s, iters) for s in pgd if s[0] == "render/project")
    assert all(_inside(s, iters) for s in pgd if s[0].startswith(("pgd/", "detector/"))
               and s[0] != "pgd/iter")


def test_nothing_recording_never_enters_record_function(monkeypatch):
    calls = []

    def stub(name):
        calls.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "record_function", stub)
    scene, exts = _problem(24)
    trainer = Trainer(scene, TrainConfig(), 1.0, device="cpu")
    trainer.train_step(exts[0].build(device="cpu"), torch.zeros(32, 32, 3))
    with profiling.annotate("outer"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("outer"):
            pass
    assert calls == ["outer"]


def test_pairs_binned_counts_the_binnings_pairs():
    scene, exts = _problem()
    proj = stack_projections([project(scene, e.build(device="cpu")) for e in exts])
    before = profiling.counters()
    traced = profiling.counters(traced=True).get("pairs_binned", 0)
    bins = bin_views(proj, 32, 32, pairs_per_gaussian=16)
    each = [bin_gaussians(proj.mean2d[v], proj.depth[v], proj.radius_tight[v], 32, 32, 16,
                          conic=proj.conic[v], opacity=proj.opacity[v]).gauss_idx.shape[0]
            for v in range(2)]
    got = profiling.counters()["pairs_binned"] - before.get("pairs_binned", 0)
    assert got == sum(each) == bins.gauss_idx.shape[0] > 0
    assert profiling.counters(traced=True).get("pairs_binned", 0) == traced
    with profile(activities=[ProfilerActivity.CPU]):
        bin_views(proj, 32, 32, pairs_per_gaussian=16)
    assert profiling.counters(traced=True)["pairs_binned"] - traced == got


class _Lib:
    """The C entry points, answering 0 (launched) and writing nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def stub_launches(monkeypatch):
    for mod in (blend, gather, gather_sum):
        monkeypatch.setattr(mod, "_load", lambda: _Lib())
    monkeypatch.setattr(_cuda, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())


def test_launch_counters_count_through_the_registry(stub_launches):
    assert not any(hasattr(m, a) for m in (blend, gather, gather_sum)
                   for a in ("FWD_LAUNCHES", "BWD_LAUNCHES", "GATHER_SUM_LAUNCHES",
                             "GATHER_LAUNCHES"))
    before = profiling.counters()
    v, n, ch, p = 1, 4, 3, 6
    idx = torch.zeros(p, dtype=torch.int32)
    start = torch.zeros((v, 1), dtype=torch.int32)
    inputs = (idx, start, start + p, torch.zeros(v, n, 2), torch.zeros(v, n, 3),
              torch.zeros(v, n), torch.zeros(v, n, ch))
    img, T, last = blend.forward_kernel(*inputs, 1, 1, 2048)
    blend.backward_kernel(*inputs, 1, 1, T, last, torch.zeros_like(img), torch.zeros_like(T))
    gather_sum.gather_sum_rows(torch.zeros(p, 9), torch.zeros((n, 2), dtype=torch.int32))
    gather_sum._launch(torch.zeros(p, 9), torch.zeros((n, 2), dtype=torch.int32))
    gather_sum._launch(torch.zeros(p, 9), torch.zeros((n, 0), dtype=torch.int32))  # no launch
    gather._launch(torch.zeros(5, 4), torch.zeros(3, dtype=torch.int32), 256, 4)
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in
           ("blend_fwd_launches", "blend_bwd_launches", "gather_sum_launches", "gather_launches")}
    # gather_sum_rows on CPU tensors takes the plain route: no launch.
    assert got == {"blend_fwd_launches": 1, "blend_bwd_launches": 1, "gather_sum_launches": 1,
                   "gather_launches": 1}
