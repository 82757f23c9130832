"""The port's Faster R-CNN R50-FPN (`gsattack_torch.models.frcnn`,
`convert_frcnn`) against `gsattack.models.frcnn` at 128x128, 8 classes, 16
proposals (as `tests/test_frcnn_parity.py`), on seeded random flax
variables carried across by `gsattack_torch.convert`.

The image gradient is compared in float64 (both packages): the stem's max
pool picks one input of each 3 x 3 window, and where two inputs lie
within float32 rounding of each other the two packages may pick
differently; the gradient then differs by O(1) over that input's 7 x 7
receptive field. With inputs x * 255 such near-ties turn up about once in
two 128x128 images. Every other quantity is compared in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.models import convert_frcnn as jconvert
from gsattack.models import frcnn as jfrcnn
from gsattack_torch.convert import detector_from_jax
from gsattack_torch.models import frcnn as tfrcnn
from tests.torch_port import max_rel_err, np_, random_variables

torch.set_num_threads(2)

NC, PROPS, HW = 8, 16, 128


def frcnn_variables(jd, seed: int, dtype=np.float32):
    key = jax.random.PRNGKey(0)
    main = jax.eval_shape(jd.model.init, key, jnp.zeros((1, HW, HW, 3)))
    roi = jax.eval_shape(lambda k, x: jd.model.init(k, x, method=jfrcnn.D2FasterRCNN.roi), key,
                         jnp.zeros((1, 7, 7, 256)))
    shapes = {"params": {**main["params"], **roi["params"]}, "batch_stats": main["batch_stats"]}
    return random_variables(shapes, seed, dtype)


@pytest.fixture(scope="module")
def pair():
    jd = jfrcnn.FasterRCNNDetector(num_classes=NC, num_proposals=PROPS)
    jd.params = frcnn_variables(jd, seed=0)
    return jd, detector_from_jax(jd, device="cpu")


@pytest.fixture(scope="module")
def ref_heads(pair):
    """One view and the reference's FPN levels and RPN outputs for it."""
    jd, _ = pair
    x = _images(1, 1)
    return (x, *jd._backbone(jd.params, jnp.asarray(x)))


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(size=(n, HW, HW, 3)).astype(np.float32)


BOXES = np.array([[10, 12, 90, 100], [30, 20, 70, 120]], np.float32)


def test_backbone_and_rpn_outputs_match(pair, ref_heads):
    _, td = pair
    x, jfpn, jrpn = ref_heads
    with torch.no_grad():
        tfpn, trpn = td(torch.tensor(x))
    assert len(tfpn) == len(jfpn) == 5
    ref = list(jfpn) + [t for pair_ in jrpn for t in pair_]
    got = list(tfpn) + [t for pair_ in trpn for t in pair_]
    for r, g in zip(ref, got):
        assert max_rel_err(np_(g).transpose(0, 2, 3, 1), r) <= 1e-5


def test_roi_align_matches():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 16, 24, 32)).astype(np.float32)
    boxes = np.stack([
        np.array([[8, 8, 60, 48], [0, 0, 128, 96], [33.3, 17.9, 77.2, 63.1],
                  [-5, -3, 20, 14], [100, 70, 140, 110]], np.float32),
        rng.uniform(0, 100, size=(5, 4)).astype(np.float32)])
    boxes[1, :, 2:] = boxes[1, :, :2] + rng.uniform(1, 40, size=(5, 2))
    got = tfrcnn.roi_align(torch.tensor(feat), torch.tensor(boxes), stride=4)
    for i in range(2):
        ref = jfrcnn.roi_align(jnp.asarray(feat[i].transpose(1, 2, 0)), jnp.asarray(boxes[i]), 4)
        np.testing.assert_allclose(np_(got[i]).transpose(0, 2, 3, 1), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_roi_features_pool_each_box_on_its_level(pair):
    """Boxes of every FPN level (P2..P5) at once, against the reference's
    pooling of every box on every level."""
    jd, td = pair
    rng = np.random.default_rng(6)
    fpn = [rng.normal(size=(1, HW // s, HW // s, 256)).astype(np.float32) for s in (4, 8, 16, 32)]
    sides = np.array([40, 60, 150, 200, 300, 420, 600, 900], np.float32)
    corner = rng.uniform(-20, 60, size=(8, 2)).astype(np.float32)
    boxes = np.concatenate([corner, corner + sides[:, None]], 1)
    ref = jd._roi_features([jnp.asarray(f) for f in fpn], jnp.asarray(boxes))
    got = td._roi_features([torch.tensor(f).permute(0, 3, 1, 2) for f in fpn],
                           torch.tensor(boxes)[None])
    assert set(np_(tfrcnn.fpn_level_for_boxes(torch.tensor(boxes)))) == {0, 1, 2, 3}
    np.testing.assert_allclose(np_(got[0]).transpose(0, 2, 3, 1), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_proposals_and_sampled_rois_match_with_ties(pair, ref_heads):
    """Both sides get the same FPN and RPN arrays (the reference's), with
    the objectness rounded so that many logits tie: the selected proposal
    and ROI indices must be equal, ties going to the lower index."""
    jd, td = pair
    _, jfpn, jrpn = ref_heads
    jrpn = [(jnp.round(o * 2) / 2, d) for o, d in jrpn]
    ref_p, ref_s = jd._proposals(jfpn, jrpn, (HW, HW))
    tfpn = [torch.tensor(np.asarray(f)).permute(0, 3, 1, 2) for f in jfpn]
    trpn = [tuple(torch.tensor(np.asarray(t)).permute(0, 3, 1, 2) for t in p) for p in jrpn]
    got_p, got_s = td._proposals(tfpn, trpn, (HW, HW))
    np.testing.assert_array_equal(np_(got_s)[0], np.asarray(ref_s))
    np.testing.assert_allclose(np_(got_p)[0], np.asarray(ref_p), rtol=1e-6, atol=1e-4)
    assert len(np.unique(np.asarray(ref_s))) < PROPS  # the ranking crossed ties
    for gt in (BOXES[:1], np.asarray(ref_p)[:1] + 1.0):
        ref_r, ref_l = jd._sample_rois(ref_p, ref_s, jnp.asarray(gt), 3)
        got_r, got_l = td._sample_rois(got_p, got_s, torch.tensor(gt)[None], 3)
        np.testing.assert_allclose(np_(got_r)[0], np.asarray(ref_r), rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(np_(got_l)[0], np.asarray(ref_l))


def test_loss_matches(pair):
    jd, td = pair
    x = _images(4)
    ref = jax.jit(lambda im: jd.loss(im, 2, BOXES))(jnp.asarray(x))
    got = td.loss(torch.tensor(x), 2, BOXES)
    assert abs(got.item() - float(ref)) <= 1e-4 * abs(float(ref))


def test_image_gradient_matches_in_float64():
    x = _images(4)
    with jax.enable_x64(True):
        jd = jfrcnn.FasterRCNNDetector(num_classes=NC, num_proposals=PROPS)
        jd.params = frcnn_variables(jd, seed=0, dtype=np.float64)
        ref = np.asarray(jax.jit(jax.grad(lambda im: jd.loss(im, 2, BOXES)))(
            jnp.asarray(x, jnp.float64)))
        td = detector_from_jax(jd, device="cpu").double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    td.loss(xt, 2, BOXES).backward()
    assert max_rel_err(xt.grad, ref) <= 1e-3
    assert np.abs(np_(xt.grad)).max() > 0


def test_predict_matches(pair):
    jd, td = pair
    img = _images(5, 1)[0]
    for thr in (0.3,):
        ref, got = jd.predict(img, thr), td.predict(img, thr)
        np.testing.assert_array_equal(got.classes, ref.classes)
        np.testing.assert_allclose(got.boxes, ref.boxes, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4, atol=1e-6)


def test_detectron2_archive_loads_and_round_trips(pair, tmp_path):
    """The port's state dict holds detectron2's keys: the JAX package's
    detectron2 converter rebuilds the flax variables from it exactly, and
    a Checkpointer-style archive (with the pixel and anchor buffers the
    port drops) loads strictly into a fresh detector."""
    jd, td = pair
    sd = {k: np_(v) for k, v in td.model.state_dict().items()}
    rebuilt = dict(jax.tree_util.tree_leaves_with_path(jconvert.convert_state_dict(sd, jd.params)))
    for path, v in jax.tree_util.tree_leaves_with_path(jd.params):
        np.testing.assert_array_equal(np.asarray(rebuilt[path]), np.asarray(v), err_msg=str(path))
    extra = {"pixel_mean": np.zeros((3, 1, 1), np.float32),
             "proposal_generator.anchor_generator.cell_anchors.0": np.zeros((3, 4), np.float32)}
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": {k: torch.tensor(v) for k, v in {**sd, **extra}.items()}}, path)
    det = tfrcnn.FasterRCNNDetector(NC, seed=5, num_proposals=PROPS, weights=path, device="cpu")
    for k, v in det.model.state_dict().items():
        np.testing.assert_array_equal(np_(v), sd[k], err_msg=k)
