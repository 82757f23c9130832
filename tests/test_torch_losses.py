"""`gsattack_torch.utils.losses` against `gsattack.utils.losses` on the
same numpy inputs: SSIM, D-SSIM + L1 (value and image gradient) and PSNR
at 1e-5, the learning-rate schedule at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.utils import losses as jl
from gsattack_torch.utils import losses as tl
from tests.torch_port import max_rel_err, np_

torch.set_num_threads(2)


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (21, 27, 3)])
def test_image_losses_match(shape):
    a, b = _pair(shape)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("ssim", "dssim_l1_loss", "psnr", "l1_loss", "l2_loss"):
        got = float(getattr(tl, name)(ta, tb))
        want = float(getattr(jl, name)(ja, jb))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (name, got, want)
    np.testing.assert_allclose(np_(tl.mse(ta, tb)), np.asarray(jl.mse(ja, jb)), rtol=1e-5)


def test_dssim_l1_gradient_matches():
    a, b = _pair((2, 32, 32, 3), seed=1)
    x = torch.tensor(a, requires_grad=True)
    (g,) = torch.autograd.grad(tl.dssim_l1_loss(x, torch.tensor(b), 0.2), [x])
    want = jax.grad(lambda z: jl.dssim_l1_loss(z, jnp.asarray(b), 0.2))(jnp.asarray(a))
    assert max_rel_err(g, want) <= 1e-5


@pytest.mark.parametrize(
    "args",
    [(1.6e-4, 1.6e-6, 0, 0.01, 30_000), (1.6e-4, 1.6e-6, 500, 0.01, 30_000),
     (0.0, 0.0, 0, 1.0, 100), (5e-3, 5e-3, 0, 1.0, 1000)],
    ids=["no-delay", "delay", "all-zero", "flat"],
)
def test_expon_lr_schedule_matches(args):
    got_f, want_f = tl.expon_lr_schedule(*args), jl.expon_lr_schedule(*args)
    for step in (-1, 0, 1, 7, 250, 499, 500, 15_000, 29_999, 30_000, 40_000):
        got, want = got_f(step), float(want_f(step))
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-30, (step, got, want)
