"""The port's DETR demo model (`gsattack_torch.models.detr`,
`convert_detr`) against `gsattack.models.detr` at the JAX DETR tests'
size (96x96, 8 classes, 16 queries), on seeded random flax variables
carried across by `gsattack_torch.convert`. As in `test_torch_frcnn.py`,
the image gradient is compared in float64, where the stem max pool's
near-ties cannot flip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.models import convert_detr as jconvert
from gsattack.models import detr as jdetr
from gsattack_torch.convert import detector_from_jax
from gsattack_torch.models import detr as tdetr
from tests.torch_port import max_rel_err, np_, random_variables

torch.set_num_threads(2)

NC, QUERIES, HW = 8, 16, 96
BOXES = np.array([[10, 12, 80, 70], [30, 20, 60, 90]], np.float32)


def detr_pair(seed: int = 0, dtype=np.float32):
    jd = jdetr.DetrDetector(num_classes=NC, num_queries=QUERIES)
    shapes = jax.eval_shape(jd.model.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    jd.params = random_variables(shapes, seed, dtype)
    jd._fwd = jax.jit(lambda p, x: jd.model.apply(p, x))
    return jd, detector_from_jax(jd, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return detr_pair()


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(size=(n, HW, HW, 3)).astype(np.float32)


def test_forward_matches(pair):
    jd, td = pair
    x = _images(1)
    ref_cls, ref_box = jd._fwd(jd.params, jd._norm(jnp.asarray(x)))
    with torch.no_grad():
        got_cls, got_box = td(torch.tensor(x))
    assert got_cls.shape == (2, QUERIES, NC + 1) and got_box.shape == (2, QUERIES, 4)
    assert max_rel_err(got_cls, ref_cls) <= 1e-5
    assert max_rel_err(got_box, ref_box) <= 1e-5


def test_greedy_and_hungarian_match():
    """Costs with ties (the first index wins) and several GTs per view,
    batched on the port's side."""
    rng = np.random.default_rng(2)
    cost = np.round(rng.uniform(size=(3, 12, 4)) * 4).astype(np.float32) / 4
    got = tdetr.greedy_match(torch.tensor(cost))
    for b in range(3):
        ref = jdetr.greedy_match(jnp.asarray(cost[b]))
        np.testing.assert_array_equal(np_(got[b]), np.asarray(ref))
        np.testing.assert_array_equal(tdetr.hungarian_match(cost[b]),
                                      jdetr.hungarian_match(cost[b]))


def test_loss_matches(pair):
    jd, td = pair
    x = _images(3)
    ref = jax.jit(lambda im: jd.loss(im, 2, BOXES))(jnp.asarray(x))
    got = td.loss(torch.tensor(x), 2, BOXES)
    assert abs(got.item() - float(ref)) <= 1e-4 * abs(float(ref))


def test_image_gradient_matches_in_float64():
    x = _images(3)
    with jax.enable_x64(True):
        jd, td = detr_pair(dtype=np.float64)
        ref = np.asarray(jax.jit(jax.grad(lambda im: jd.loss(im, 2, BOXES)))(
            jnp.asarray(x, jnp.float64)))
    td = td.double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    td.loss(xt, 2, BOXES).backward()
    assert max_rel_err(xt.grad, ref) <= 1e-3
    assert np.abs(np_(xt.grad)).max() > 0


def test_predict_matches(pair):
    jd, td = pair
    img = _images(4, 1)[0]
    for thr in (0.0, 0.15):
        ref, got = jd.predict(img, thr), td.predict(img, thr)
        np.testing.assert_array_equal(got.classes, ref.classes)
        np.testing.assert_allclose(got.boxes, ref.boxes, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4, atol=1e-6)


def test_demo_archive_loads_and_round_trips(pair, tmp_path):
    """The port's state dict holds the demo checkpoint's keys: the JAX
    package's DETR converter rebuilds the flax variables from it exactly,
    and the archive (with torchvision's `num_batches_tracked`) loads
    strictly into a fresh detector."""
    jd, td = pair
    sd = {k: np_(v) for k, v in td.model.state_dict().items()}
    assert "transformer.decoder.layers.5.multihead_attn.in_proj_weight" in sd
    rebuilt = dict(jax.tree_util.tree_leaves_with_path(jconvert.convert_state_dict(sd, jd.params)))
    for path, v in jax.tree_util.tree_leaves_with_path(jd.params):
        np.testing.assert_array_equal(np.asarray(rebuilt[path]), np.asarray(v), err_msg=str(path))
    path = str(tmp_path / "detr_demo.pth")
    extra = {"backbone.bn1.num_batches_tracked": torch.zeros((), dtype=torch.long)}
    torch.save({**{k: torch.tensor(v) for k, v in sd.items()}, **extra}, path)
    det = tdetr.DetrDetector(NC, seed=3, num_queries=QUERIES, weights=path, device="cpu")
    for k, v in det.model.state_dict().items():
        np.testing.assert_array_equal(np_(v), sd[k], err_msg=k)
