"""The attack slice of `gsattack_torch` against `gsattack`: PGD steps,
silhouette boxes, the toy detector, the success rule, and `run_dagger`
end to end on a small scene with the same detector weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.attack import AttackConfig as JConfig
from gsattack.attack import pgd as jpgd
from gsattack.attack import run_dagger as j_run_dagger
from gsattack.attack.silhouette import silhouette_bbox as j_bbox
from gsattack.models import ToyDetector as JToy
from gsattack.models import base as jbase
from gsattack_torch.attack import AttackConfig as TConfig
from gsattack_torch.attack import pgd as tpgd
from gsattack_torch.attack import run_dagger as t_run_dagger
from gsattack_torch.attack.silhouette import silhouette_bbox as t_bbox
from gsattack_torch.convert import toy_detector_from_numpy
from gsattack_torch.core.camera import CameraExtrinsics as TExtrinsics
from gsattack_torch.models import base as tbase
from tests.conftest import make_toy_scene
from tests.test_attack import _toy_views
from tests.torch_port import np_, port_scene

torch.set_num_threads(2)


def _toy_pair(num_classes=8):
    jdet = JToy(num_classes=num_classes)
    jdet.load_model()
    tdet = toy_detector_from_numpy(
        {k: np.asarray(v) for k, v in jdet.params.items()}, num_classes, 16, device="cpu"
    )
    return jdet, tdet


@pytest.mark.parametrize(
    "norm,attrs,masked",
    [("l2", ("color",), False), ("linf", ("position", "opacity"), False),
     ("l2", ("rotation", "scaling", "objects"), True)],
)
def test_pgd_attack_step_matches(norm, attrs, masked):
    js = make_toy_scene(n=24, seed=3)
    rng = np.random.default_rng(4)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in js.params().items()}
    grads["f_rest"][:] = 0.0  # the zero-gradient branch of the l2 step
    orig = {k: np.asarray(v) + 0.01 for k, v in js.params().items()}
    mask = rng.uniform(size=24) > 0.5 if masked else None
    ref = jpgd.pgd_attack_step(
        js, {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in orig.items()}, 0.3, 0.05, attrs, norm, True,
        None if mask is None else jnp.asarray(mask),
    )
    got = tpgd.pgd_attack_step(
        port_scene(js), {k: torch.tensor(v) for k, v in grads.items()},
        {k: torch.tensor(v) for k, v in orig.items()}, 0.3, 0.05, attrs, norm, True,
        None if mask is None else torch.tensor(mask),
    )
    for k, v in ref.params().items():
        np.testing.assert_allclose(np_(got.params()[k]), np.asarray(v), rtol=1e-6, atol=1e-6, err_msg=k)


def test_named_step_wrappers_match_the_reference_surface():
    names = [n for n in dir(jpgd) if n.startswith("gaussian_") and n.endswith(("attack", "masked"))]
    assert len(names) == 11
    for n in names:
        assert callable(getattr(tpgd, n)), n
    assert tpgd.ATTR_MAP == jpgd.ATTR_MAP


def test_silhouette_bbox_matches():
    rng = np.random.default_rng(0)
    img = np.zeros((24, 40, 3), np.float32)
    img[5:13, 9:30] = rng.uniform(0.2, 1.2, size=(8, 21, 3))
    for im in (img, np.zeros_like(img)):
        np.testing.assert_array_equal(np_(t_bbox(torch.tensor(im))), np.asarray(j_bbox(jnp.asarray(im))))


def test_toy_detector_loss_grad_and_predict_match(tmp_path):
    jdet, tdet = _toy_pair()
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(2, 40, 48, 3)).astype(np.float32)
    boxes = np.array([[4, 4, 30, 24], [0, 8, 48, 40]], np.float32)
    l_ref, g_ref = jax.value_and_grad(lambda x: jdet.loss(x, 3, boxes))(jnp.asarray(imgs))
    x = torch.tensor(imgs, requires_grad=True)
    loss = tdet.loss(x, 3, boxes)
    loss.backward()
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    np.testing.assert_allclose(np_(x.grad), np.asarray(g_ref), rtol=1e-4, atol=1e-7)
    for thr in (0.0, 0.05):
        dj, dt = jdet.predict(imgs[0], thr), tdet.predict(imgs[0], thr)
        np.testing.assert_array_equal(dt.classes, dj.classes)
        np.testing.assert_allclose(dt.boxes, dj.boxes)
        np.testing.assert_allclose(dt.scores, dj.scores, rtol=1e-5)
    png = tmp_path / "pred.png"
    kw = dict(image=imgs[0], target=3, threshold=0.0, gt_bbox=boxes[0])
    assert tdet.predict_and_save(path=str(png), **kw) == jdet.predict_and_save(**kw)
    assert png.exists()


def test_nms_iou_and_success_rule_match():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 50, size=(30, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, size=(30, 2))], axis=1).astype(np.float32)
    scores = rng.uniform(size=30).astype(np.float32)
    np.testing.assert_array_equal(tbase.nms(boxes, scores), jbase.nms(boxes, scores))
    np.testing.assert_allclose(tbase.box_iou(boxes, boxes[:4]), jbase.box_iou(boxes, boxes[:4]))
    classes = rng.integers(0, 4, size=30)
    for gt in (boxes[3], None):
        for args in ((1, None, True), (2, 1, True), (None, 0, False)):
            tj = jbase.Detections(boxes, scores, classes)
            tt = tbase.Detections(boxes, scores, classes)
            assert tbase.evaluate_success(tt, gt, *args) == jbase.evaluate_success(tj, gt, *args)


def test_run_dagger_matches_reference(tmp_path):
    """48 splats, 32x32, a batch of 2 views, 3 PGD iterations with a
    success evaluation after each: the reference with its XLA blend, the
    port on the CPU, the same toy-detector weights."""
    js = make_toy_scene(n=48, seed=0).replace(active_sh_degree=3)
    jdet, tdet = _toy_pair()
    views = _toy_views(2, 32, 32)
    kw = dict(
        epsilon=5.0, alpha=0.5, max_iters=4, batch_mode=True, batch_size=2, target=2,
        eval_every=1, attack_conf_thresh=0.9, output_dir=str(tmp_path),
    )
    ref = j_run_dagger(js, views, jdet, JConfig(**kw), log=lambda *_: None)
    tviews = [TExtrinsics(v.R, v.T, v.fovx, v.fovy, v.width, v.height, uid=v.uid) for v in views]
    got = t_run_dagger(port_scene(js), tviews, tdet, TConfig(**kw), log=lambda *_: None)
    assert len(got.losses) == len(ref.losses) == 3
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for k in ("f_dc", "f_rest"):
        np.testing.assert_allclose(
            np_(getattr(got.scene, k)), np.asarray(getattr(ref.scene, k)), atol=1e-5, err_msg=k
        )
    assert np.abs(np_(got.scene.f_rest) - np.asarray(js.f_rest)).max() > 0
    np.testing.assert_array_equal(np_(got.scene.xyz), np.asarray(js.xyz))
    assert (got.success, got.iterations) == (ref.success, ref.iterations)


def test_run_dagger_success_writes_ply_and_checkpoint_resumes(tmp_path, monkeypatch):
    """Every view fooled at once: the attack ends and writes the PLY. A
    checkpointed run resumed from its state ends where one run does."""
    js = make_toy_scene(n=32, seed=1)
    _, tdet = _toy_pair()
    views = [TExtrinsics(v.R, v.T, v.fovx, v.fovy, 32, 32) for v in _toy_views(4, 32, 32)]
    monkeypatch.setattr(tdet, "predict_and_save", lambda **kw: True)
    cfg = TConfig(max_iters=5, batch_size=2, target=1, output_dir=str(tmp_path), scene_name="toy")
    res = t_run_dagger(port_scene(js), views, tdet, cfg, log=lambda *_: None)
    assert res.success and res.adv_ply_path == str(tmp_path / "toy_adv_toy.ply")
    assert (tmp_path / "toy_adv_toy.ply").exists()
    monkeypatch.undo()

    common = dict(batch_size=2, target=2, eval_every=100, attack_conf_thresh=0.99,
                  output_dir=str(tmp_path), checkpoint_every=2, save_ply=False)
    views = views[:2]
    full = t_run_dagger(port_scene(js), views, tdet, TConfig(max_iters=6, **common),
                        log=lambda *_: None)
    # 3 iterations (the checkpoint lands at it=2), then resume to 6.
    ck = str(tmp_path / "ck")
    t_run_dagger(port_scene(js), views, tdet, TConfig(max_iters=3, checkpoint_dir=ck, **common),
                 log=lambda *_: None)
    resumed = t_run_dagger(
        port_scene(js), views, tdet,
        TConfig(max_iters=6, checkpoint_dir=ck, resume=True, **common), log=lambda *_: None,
    )
    np.testing.assert_allclose(resumed.losses, full.losses, rtol=1e-5)
    np.testing.assert_allclose(np_(resumed.scene.f_dc), np_(full.scene.f_dc), atol=1e-6)


@pytest.mark.parametrize(
    "change", [dict(pairs_budget=256), dict(compact_budget=128),
               dict(tier_split=2, heavy_budget=8, pairs_per_gaussian=4, rect_candidates=4),
               dict(heavy_budget=1, tier_split=1, pairs_per_gaussian=4, rect_candidates=8),
               dict(pairs_per_gaussian=-1, rect_candidates=-1)],
)
def test_run_dagger_refuses_pack_layout_caps(change, tmp_path, monkeypatch):
    """Each static cap runs in run_dagger on the "pallas" route (48 splats,
    32x32, 180 pairs over 4 tiles: each setting binds) and its drops are
    counted: the loss render counts what the binning drops at the same
    settings, more than it drops without them; -1 is sized by the probes."""
    from gsattack_torch.attack import dagger as tdagger
    from gsattack_torch.ops.project import project, stack_projections
    from gsattack_torch.ops.raster import auto_pair_caps

    js = make_toy_scene(n=48, seed=1)
    _, tdet = _toy_pair()
    views = [TExtrinsics(np.eye(3), np.zeros(3), 1.0, 1.0, 32, 32)]
    counts = []
    tdagger_rasterize = tdagger.rasterize_views

    def counted(*a, **kw):
        out = tdagger_rasterize(*a, **kw)
        if out["render"].requires_grad:
            counts.append(int(out["num_culled_pairs"]) + int(out["num_truncated_pairs"]))
        return out

    monkeypatch.setattr(tdagger, "rasterize_views", counted)
    lines = []
    cfg = TConfig(max_iters=2, batch_size=1, target=2, backend="pallas", save_ply=False,
                  output_dir=str(tmp_path), **change)
    res = t_run_dagger(port_scene(js), views, tdet, cfg, log=lines.append)
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()
    scene, cam = port_scene(js), views[0].build(device="cpu")
    proj = stack_projections([project(scene, cam)])
    if change.get("pairs_per_gaussian") == -1:
        pairs, rect = auto_pair_caps(project(scene, cam), 32, 32)
        sized = f"[Info] Auto-sized pairs_per_gaussian = {pairs}, rect_candidates = {rect}"
        assert sized in lines and len(counts) == 1
        return
    settings = dict(pairs_per_gaussian=32, rect_candidates=0) | change
    pairs, rect = settings.pop("pairs_per_gaussian"), settings.pop("rect_candidates")

    def dropped(**caps):
        out = tdagger_rasterize(proj, 32, 32, torch.zeros(3), pairs, 64, 16,
                                rect_candidates=rect, backend="pallas", **caps)
        return int(out["num_culled_pairs"]) + int(out["num_truncated_pairs"])

    assert counts == [dropped(**settings)] and counts[0] > dropped()
