"""The detector slice of `gsattack_torch` as a whole: `load_detector`
against the JAX factory, `run_dagger` with a YOLO head against the JAX
`run_dagger` on the same scene and weights, and the port's independence
from the JAX package."""

import ast
import os

import numpy as np
import pytest
import torch

from gsattack import models as jmodels
from gsattack.attack import AttackConfig as JConfig
from gsattack.attack import run_dagger as j_run_dagger
from gsattack.models.yolo import YoloDetector as JYolo
from gsattack_torch import models as tmodels
from gsattack_torch.attack import AttackConfig as TConfig
from gsattack_torch.attack import run_dagger as t_run_dagger
from gsattack_torch.core.camera import CameraExtrinsics as TExtrinsics
from tests.conftest import make_toy_scene
from tests.test_attack import _toy_views
from tests.test_torch_yolo import yolo_pair
from tests.torch_port import np_, port_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, kwargs) as a caller of the JAX factory gives them.
FACTORY_CASES = [
    ("toy", dict(num_classes=5, seed=1)),
    ("yolov3", dict(num_classes=4, imgsz=64, seed=2)),
    ("yolov5", dict(num_classes=4, imgsz=96)),
    ("yolov8", dict(num_classes=80)),
    ("yolov11", dict(num_classes=3, imgsz=64, seed=4)),
    ("detectron2", dict(num_classes=6, seed=5, num_proposals=32)),
    ("detr", dict(num_classes=7, num_queries=12)),
]
ATTRS = ("name", "nc", "num_classes", "imgsz", "family", "variant", "seed", "num_proposals",
         "num_queries", "channels", "class_names")


def _config(det):
    return {a: getattr(det, a) for a in ATTRS if hasattr(det, a)}


@pytest.mark.parametrize("name,kwargs", FACTORY_CASES, ids=[c[0] for c in FACTORY_CASES])
def test_load_detector_matches_the_jax_factory(name, kwargs):
    ref = jmodels.load_detector(name, **kwargs)
    got = tmodels.load_detector(name, device="cpu", **kwargs)
    assert type(got).__name__ == type(ref).__name__
    assert _config(got) == _config(ref)
    assert got.resolve_label_index(got.class_names[-1]) == len(got.class_names) - 1
    assert got.resolve_label_index(1) == ref.resolve_label_index(1)
    assert got.resolve_label_index(10_000) == "unknown"
    assert isinstance(got, torch.nn.Module) and not any(
        p.requires_grad for p in got.parameters())


@pytest.mark.parametrize("key", ["yolov8s", "yolov5n", "yolov11m"])
def test_load_detector_takes_yolo_scale_keys(key):
    got = tmodels.load_detector(key, num_classes=4, imgsz=64, device="cpu")
    ref = JYolo(key, num_classes=4, imgsz=64)
    assert (got.family, got.variant) == (ref.family, ref.variant) == (key[: -1], key)


def test_load_detector_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="Unknown detector"):
        tmodels.load_detector("yolov9", device="cpu")
    if not torch.cuda.is_available():
        for name in ("toy", "yolov8", "detectron2", "detr"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tmodels.load_detector(name)

    @tmodels.register_detector("toy_copy")
    class ToyCopy(tmodels.ToyDetector):
        pass

    assert isinstance(tmodels.load_detector("toy_copy", num_classes=3, device="cpu"), ToyCopy)


def test_detections_to_coco_matches():
    from gsattack.models.base import Detections as JDetections
    from gsattack.models.base import detections_to_coco as j_coco

    rng = np.random.default_rng(0)
    boxes = np.sort(rng.uniform(0, 90, size=(5, 2, 2)), axis=1).reshape(5, 4)[:, [0, 2, 1, 3]]
    scores, classes = rng.uniform(size=5).astype(np.float32), rng.integers(0, 9, 5)
    got = tmodels.detections_to_coco(tmodels.Detections(boxes, scores, classes), image_id=3)
    assert got == j_coco(JDetections(boxes, scores, classes), image_id=3)


def test_run_dagger_with_yolov8_matches_reference(tmp_path):
    """48 splats, 32x32, a batch of 2 views, 3 PGD iterations with a
    success evaluation after each, yolov8n at imgsz 64 (4 classes) on the
    same weights: the reference with its XLA blend, the port on the CPU."""
    js = make_toy_scene(n=48, seed=0).replace(active_sh_degree=3)
    jdet, tdet = yolo_pair("yolov8", seed=9)
    views = _toy_views(2, 32, 32)
    kw = dict(epsilon=5.0, alpha=0.5, max_iters=4, batch_mode=True, batch_size=2, target=2,
              eval_every=1, attack_conf_thresh=0.9, output_dir=str(tmp_path),
              detector_name="yolov8")
    ref = j_run_dagger(js, views, jdet, JConfig(**kw), log=lambda *_: None)
    tviews = [TExtrinsics(v.R, v.T, v.fovx, v.fovy, v.width, v.height, uid=v.uid) for v in views]
    got = t_run_dagger(port_scene(js), tviews, tdet, TConfig(**kw), log=lambda *_: None)
    assert len(got.losses) == len(ref.losses) == 3
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(np_(got.scene.f_dc), np.asarray(ref.scene.f_dc), atol=1e-5)
    assert np.abs(np_(got.scene.f_dc) - np.asarray(js.f_dc)).max() > 0
    assert (got.success, got.iterations) == (ref.success, ref.iterations)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_imports_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gsattack_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "gsattack", "tests")]
    assert bad == []
