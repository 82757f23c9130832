"""The port's YOLO family (`gsattack_torch.models.yolo`, `yolo_blocks`,
`convert_yolo`) against `gsattack.models.yolo` on the same weights: flax
variables of seeded random values (randomised batch-norm statistics
included) carried across by `gsattack_torch.convert`, the same numpy
inputs on both sides, at imgsz 64 and 4 classes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.models import convert_yolo as jconvert
from gsattack.models import yolo as jyolo
from gsattack_torch.convert import detector_from_jax
from gsattack_torch.models import yolo as tyolo
from gsattack_torch.models.convert_yolo import load_into
from tests.torch_port import max_rel_err, np_, random_variables

torch.set_num_threads(2)

NC, IMGSZ = 4, 64
VARIANTS = ["yolov8", "yolov5", "yolov3", "yolov11"]


def yolo_pair(variant: str, seed: int = 0):
    """A JAX YoloDetector holding seeded random variables (made without
    its eager flax init), and the port's detector with the same weights."""
    jd = jyolo.YoloDetector(variant, num_classes=NC, imgsz=IMGSZ)
    shapes = jax.eval_shape(jd.model.init, jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)))
    jd.params = jd._bias_init(random_variables(shapes, seed))
    jd._fwd = jax.jit(lambda p, x: jd.model.apply(p, x))
    return jd, detector_from_jax(jd, device="cpu")


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    return yolo_pair(request.param)


def test_head_outputs_match(pair):
    jd, td = pair
    x = np.random.default_rng(1).uniform(size=(2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    ref = jd._fwd(jd.params, jnp.asarray(x))
    with torch.no_grad():
        got = td.model(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 3
    for r, g, s in zip(ref, got, (8, 16, 32)):
        assert g.shape == (2, 4 * 16 + NC, IMGSZ // s, IMGSZ // s)
        np.testing.assert_allclose(np_(g).transpose(0, 2, 3, 1), np.asarray(r), rtol=0, atol=1e-4)


def test_state_dict_round_trips_through_the_reference_converter(pair):
    """The port's state dict holds ultralytics keys: the JAX package's
    ultralytics converter rebuilds the flax variables from it exactly."""
    jd, td = pair
    sd = {k: np_(v) for k, v in td.model.state_dict().items()}
    assert "model.0.conv.weight" in sd and any(".cv2.0.2.bias" in k for k in sd)
    rebuilt = jconvert.convert_state_dict(sd, jd.params)
    flat_ref = jax.tree_util.tree_leaves_with_path(jd.params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(rebuilt))
    assert len(flat_got) == len(flat_ref)
    for path, v in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(v), err_msg=str(path))


@pytest.mark.parametrize("variant", ["yolov8", "yolov11"])
def test_v8_loss_and_image_gradient_match(variant):
    jd, td = yolo_pair(variant, seed=2)
    rng = np.random.default_rng(3)
    imgs = rng.uniform(size=(2, 48, 40, 3)).astype(np.float32)
    boxes = np.array([[4, 6, 30, 40], [0, 0, 0, 0]], np.float32)  # the 2nd view: no box
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(lambda im: jd.loss(im, 1, boxes)))(
        jnp.asarray(imgs))
    x = torch.tensor(imgs, requires_grad=True)
    loss = td.loss(x, 1, boxes)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert max_rel_err(x.grad, ref_grad) <= 1e-3
    assert np.abs(np_(x.grad)).max() > 0


@pytest.mark.parametrize("shape", [(80, 80), (50, 80), (24, 40)])
def test_letterbox_value_and_gradient_match(shape):
    """A shrink (80 -> 64: antialiased), a shrink with padding, and an
    enlargement with padding."""
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(2, *shape, 3)).astype(np.float32)
    w_out = rng.normal(size=(2, IMGSZ, IMGSZ, 3)).astype(np.float32)

    def ref_fn(im):
        out, scale, pad = jyolo.letterbox(im, IMGSZ)
        return (out * w_out).sum(), (out, scale, pad)

    (_, (ref, scale, pad)), ref_grad = jax.value_and_grad(ref_fn, has_aux=True)(jnp.asarray(imgs))
    x = torch.tensor(imgs, requires_grad=True)
    got, t_scale, t_pad = tyolo.letterbox(x.permute(0, 3, 1, 2), IMGSZ)
    (got * torch.tensor(w_out).permute(0, 3, 1, 2)).sum().backward()
    assert (t_scale, t_pad) == (scale, pad)
    np.testing.assert_allclose(np_(got).transpose(0, 2, 3, 1), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_(x.grad), np.asarray(ref_grad), rtol=0, atol=1e-6)


def test_task_aligned_assign_matches_on_a_tie_at_the_kth_metric():
    """16 anchors tie at GT 0's largest metric, so its 10th largest is a
    tie: every tied anchor is taken. GT 1 overlaps GT 0; GT 2 is padding."""
    anchors, _ = jyolo.make_anchors([(8, 8)], strides=(8,))
    a = anchors.shape[0]
    scores = np.full((a, 3), 0.5, np.float32)
    scores[:, 2] = np.linspace(0.1, 0.9, a)
    pred = np.concatenate([anchors - 6, anchors + 6], axis=-1)
    gt = np.array([[8, 8, 56, 56], [30, 30, 62, 50], [0, 0, 0, 0]], np.float32)
    labels = np.array([1, 2, 0])
    valid = np.array([True, True, False])
    ref = jyolo.task_aligned_assign(jnp.asarray(scores), jnp.asarray(pred), anchors,
                                    jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))
    got = tyolo.task_aligned_assign(
        torch.tensor(scores)[None], torch.tensor(np.asarray(pred))[None],
        torch.tensor(np.asarray(anchors)), torch.tensor(gt)[None], torch.tensor(labels)[None],
        torch.tensor(valid)[None])
    fg, tl, tb, ts = (np_(t)[0] for t in got)
    np.testing.assert_array_equal(fg, np.asarray(ref[0]))
    np.testing.assert_array_equal(tl[fg], np.asarray(ref[1])[fg])
    np.testing.assert_array_equal(tb[fg], np.asarray(ref[2])[fg])
    np.testing.assert_allclose(ts, np.asarray(ref[3]), rtol=1e-6, atol=0)
    assert ((tl == 1) & fg).sum() > 10  # the tie let more than k anchors in


def test_decode_ciou_and_anchors_match():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 21, 64)).astype(np.float32)
    ref_a, ref_s = jyolo.make_anchors([(4, 4), (2, 2), (1, 1)])
    got_a, got_s = tyolo.make_anchors([(4, 4), (2, 2), (1, 1)])
    np.testing.assert_array_equal(np_(got_a), np.asarray(ref_a))
    np.testing.assert_array_equal(np_(got_s), np.asarray(ref_s))
    ref = np.stack([np.asarray(jyolo.decode_boxes(jnp.asarray(l), ref_a, ref_s)) for l in logits])
    got = tyolo.decode_boxes(torch.tensor(logits), got_a, got_s)
    np.testing.assert_allclose(np_(got), ref, rtol=1e-6, atol=1e-5)
    b1 = np.concatenate([rng.uniform(0, 50, (30, 2)), rng.uniform(60, 99, (30, 2))], 1)
    b2 = (b1 + rng.normal(0, 8, b1.shape)).astype(np.float32)
    b1 = b1.astype(np.float32)
    np.testing.assert_allclose(np_(tyolo.ciou(torch.tensor(b1), torch.tensor(b2))),
                               np.asarray(jyolo.ciou(jnp.asarray(b1), jnp.asarray(b2))),
                               rtol=1e-5, atol=1e-6)


def test_predict_matches(pair):
    jd, td = pair
    img = np.random.default_rng(6).uniform(size=(56, 64, 3)).astype(np.float32)
    for thr in (0.0, 0.02):
        ref, got = jd.predict(img, thr), td.predict(img, thr)
        np.testing.assert_array_equal(got.classes, ref.classes)
        np.testing.assert_allclose(got.boxes, ref.boxes, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ext", [".npz", ".pt"])
def test_weights_archive_loads(tmp_path, ext):
    """An ultralytics flat archive (with the DFL conv and the norms'
    `num_batches_tracked`, which the port drops) loads strictly; a missing
    or misshapen entry is refused."""
    _, td = yolo_pair("yolov11", seed=7)
    sd = {k: np_(v) for k, v in td.model.state_dict().items()}
    sd["model.23.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    sd["model.0.bn.num_batches_tracked"] = np.zeros((), np.int64)
    path = str(tmp_path / f"sd{ext}")
    if ext == ".pt":
        torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    else:
        np.savez(path, **sd)
    det = tyolo.YoloDetector("yolov11", num_classes=NC, imgsz=IMGSZ, seed=99, weights=path,
                             device="cpu")
    for k, v in det.model.state_dict().items():
        np.testing.assert_array_equal(np_(v), sd[k], err_msg=k)
    bad = dict(sd)
    bad.pop("model.0.conv.weight")
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="not covered"):
        load_into(det.model, str(tmp_path / "bad.npz"))
    bad["model.0.conv.weight"] = sd["model.0.conv.weight"][:, :2]
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_into(det.model, str(tmp_path / "bad.npz"))
