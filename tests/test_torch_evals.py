"""`gsattack_torch.evals` against `gsattack.evals`: the ASR and COCO AP
analyzers (identical numbers), `run_render_eval` with the toy head carried
across (with and without a frozen overlay; the JAX analyzer reads the
port's log), the PCA colouring and the Gaussian-Grouping renders."""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack import evals as jev
from gsattack.core.camera import CameraExtrinsics as JExt
from gsattack.models import ToyDetector as JToy
from gsattack_torch import evals as tev
from gsattack_torch.convert import toy_detector_from_numpy
from gsattack_torch.core.camera import CameraExtrinsics as TExt
from gsattack_torch.io.png import read_png
from tests.conftest import make_toy_camera, make_toy_scene
from tests.torch_port import port_camera, port_scene

torch.set_num_threads(2)
RNG = np.random.default_rng(31)
CLASSES = ["car", "clock", "None", "person"]


def _write_log(path, entries):
    with open(path, "w") as f:
        f.write("2025-01-01 00:00:00,000 - INFO - [render-eval] a line without a record\n")
        for e in entries:
            f.write(f"2025-01-01 00:00:00,000 - INFO - {json.dumps(e)}\n")


def _random_entries(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for cam in range(n):
        cls = CLASSES[rng.integers(len(CLASSES))]
        box = [float(v) for v in np.round(rng.uniform(0, 40, 4), 1)]
        out.append({
            "cam": cam, "pred_class": cls,
            "pred_category_id": None if cls == "None" else int(rng.integers(0, 5)),
            "confidence": "None" if cls == "None" else f"{rng.uniform(0.2, 1):.4f}",
            "bbox": None if cls == "None" else box,
            "gt_bbox": [float(v) for v in np.round(np.asarray(box) + rng.normal(0, 3, 4), 1)],
            "iou": None,
        })
    return out


def test_asr_and_coco_ap_match(tmp_path, capsys):
    bp, ap = str(tmp_path / "b.log"), str(tmp_path / "a.log")
    _write_log(bp, _random_entries(40, 1))
    _write_log(ap, _random_entries(40, 2))
    assert tev.load_preds(bp) == jev.load_preds(bp)
    for target in ("car", "person", "truck"):
        assert tev.analyze_asr_logs(bp, ap, target) == jev.analyze_asr_logs(bp, ap, target)
    assert tev.analyze_asr_logs(bp, str(tmp_path / "missing"), "car") is None
    assert tev.compute_asr({0: "car"}, {0: "car"}, "car") == jev.compute_asr(
        {0: "car"}, {0: "car"}, "car")
    assert tev.CATEGORY_MAP == jev.CATEGORY_MAP

    files = {}
    for tag, mod in (("t", tev), ("j", jev)):
        gt, dt = str(tmp_path / f"{tag}_gt.json"), str(tmp_path / f"{tag}_dt.json")
        mod.build_coco_jsons(bp, 64, 64, gt, dt, "car", category_map={"car": 2})
        files[tag] = (open(gt).read(), open(dt).read(), mod.run_coco_eval(gt, dt, iou_thr=0.5))
    assert files["t"] == files["j"]
    assert capsys.readouterr().out.count("Average Precision") == 2

    gt = [{"image_id": int(i), "category_id": int(c), "bbox": list(RNG.uniform(0, 50, 4))}
          for i, c in zip(RNG.integers(0, 6, 30), RNG.integers(0, 3, 30))]
    dt = [{**g, "bbox": list(np.asarray(g["bbox"]) + RNG.normal(0, 4, 4)),
           "score": float(RNG.uniform())} for g in gt[:24]]
    dt += [{"image_id": int(RNG.integers(0, 6)), "category_id": 1,
            "bbox": list(RNG.uniform(0, 50, 4)), "score": float(RNG.uniform())}
           for _ in range(10)]
    for kw in ({}, {"iou_thrs": [0.5]}, {"iou_thrs": [0.3, 0.75], "max_dets": (1, 5)}):
        assert tev.COCOEvaluator(gt, dt, **kw).evaluate() == jev.COCOEvaluator(
            gt, dt, **kw).evaluate()


def _logger(name, path):
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    log.propagate = False
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    log.handlers = [fh]
    return log, fh


def compare_records(got: list, want: list) -> None:
    """The render-eval gates: equal classes, success and count; boxes
    within 1e-3 px; IoU within 1e-5."""
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        for k in ("cam", "pred_class", "pred_category_id", "gt_bbox"):
            assert g[k] == w[k], (k, g, w)
        if "success" in w:
            assert g["success"] == w["success"]
        assert (g["bbox"] is None) == (w["bbox"] is None) and (g["iou"] is None) == (
            w["iou"] is None)
        if w["bbox"] is not None:
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
        if w["iou"] is not None:
            assert abs(g["iou"] - w["iou"]) <= 1e-5


def log_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line.split(" - ")[-1]) for line in f if '"cam"' in line]


@pytest.mark.parametrize("frozen", [False, True])
def test_run_render_eval_matches(tmp_path, frozen):
    js = make_toy_scene(n=48, seed=0)
    jfrozen = make_toy_scene(n=24, seed=9, spread=0.8) if frozen else None
    views = [(np.eye(3), np.array([0.05 * i, 0.0, 0.1 * i])) for i in range(3)]
    jdet = JToy(num_classes=8)
    jdet.load_model()
    tdet = toy_detector_from_numpy({k: np.asarray(v) for k, v in jdet.params.items()}, 8, 16,
                                   device="cpu")
    outs, logs = {}, {}
    for tag, ev, ext, det, sc, fr in (
        ("j", jev, JExt, jdet, js, jfrozen),
        ("t", tev, TExt, tdet, port_scene(js), jfrozen and port_scene(jfrozen)),
    ):
        logs[tag] = str(tmp_path / f"{tag}.log")
        log, fh = _logger(f"render_{tag}_{frozen}", logs[tag])
        cfg = ev.RenderEvalConfig(
            target=2, attack_conf_thresh=0.05, white_background=frozen,
            renders_dir=str(tmp_path / tag / "renders"), preds_dir=str(tmp_path / tag / "preds"),
            save_images=frozen, pairs_per_gaussian=-1 if frozen else 32,
        )
        outs[tag] = ev.run_render_eval(sc, [ext(R, T, 1.0, 1.0, 48, 40) for R, T in views], det,
                                       cfg, frozen_scene=fr, logger=log)
        fh.close()
    compare_records(outs["t"]["records"], outs["j"]["records"])
    compare_records(log_records(logs["t"]), log_records(logs["j"]))
    assert any(r["bbox"] is not None for r in outs["j"]["records"])
    assert jev.load_preds(logs["t"]) == jev.load_preds(logs["j"])
    assert len(outs["t"]["coco"]) == len(outs["j"]["coco"])
    if frozen:
        d = {k: outs[k]["dirs"]["renders"] for k in outs}
        assert sorted(os.listdir(d["t"])) == sorted(os.listdir(d["j"]))
        for i in range(len(views)):
            a, b = (read_png(os.path.join(d[k], f"render_{i}.png")).astype(int) for k in "tj")
            assert np.abs(a - b).max() <= 1


def test_render_eval_refuses_pallas_budgets():
    cfg = tev.RenderEvalConfig(pairs_budget=4096)
    with pytest.raises(NotImplementedError, match="item 6"):
        tev.render_cli._resolve_render_caps(cfg, [], [], logging.getLogger("x"))


def test_feature_to_rgb_matches_sklearn():
    feats = [RNG.normal(size=(16, 24, 20)).astype(np.float32)]
    scene = make_toy_scene(n=48, seed=3)
    from gsattack.render import render

    feats.append(np.asarray(render(scene, make_toy_camera(32, 32), jnp.zeros(3))
                            ["render_object"]).transpose(2, 0, 1))
    for f in feats:
        got, want = tev.feature_to_rgb(f), jev.feature_to_rgb(f)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_render_grouping_set_matches(tmp_path):
    js = make_toy_scene(n=48, seed=2)
    jcams = [make_toy_camera(32, 32, z=0.0), make_toy_camera(32, 32, z=0.2)]
    w = RNG.normal(size=(4, 16)).astype(np.float32)
    b = RNG.normal(size=4).astype(np.float32)
    gts = [RNG.uniform(size=(32, 32, 3)).astype(np.float32)]
    want = jev.render_grouping_set(js, jcams, str(tmp_path / "j"), classifier=(
        jnp.asarray(w), jnp.asarray(b)), gt_images=gts)
    got = tev.render_grouping_set(port_scene(js), [port_camera(c) for c in jcams],
                                  str(tmp_path / "t"), classifier=(w, b), gt_images=gts)
    assert got["num_frames"] == want["num_frames"] == 2
    assert (got["video"] is None) == (want["video"] is None)
    for k, d in want["dirs"].items():
        names = sorted(os.listdir(d))
        assert sorted(os.listdir(got["dirs"][k])) == names, k
        for n in names:
            a = read_png(os.path.join(got["dirs"][k], n)).astype(int)
            assert np.abs(a - read_png(os.path.join(d, n)).astype(int)).max() <= 1, (k, n)
