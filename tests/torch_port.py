"""Helpers shared by the `test_torch_*` files: put one JAX scene / camera
through `gsattack_torch.convert` so both packages see the same inputs, and
compare gradients the way the Pallas parity tests do."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsattack_torch.convert import camera_from_numpy, scene_from_numpy


def port_scene(sc):
    """A `gsattack_torch` scene (CPU) holding a JAX scene's values."""
    return scene_from_numpy(
        {k: np.asarray(v) for k, v in sc.params().items()},
        np.asarray(sc.alive), sc.active_sh_degree, device="cpu",
    )


def port_camera(cam):
    """A `gsattack_torch` camera (CPU) holding a JAX camera's values."""
    return camera_from_numpy(
        np.asarray(cam.view), np.asarray(cam.full_proj), np.asarray(cam.cam_center),
        float(cam.tanfovx), float(cam.tanfovy), cam.width, cam.height, device="cpu",
    )


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def max_rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|: the gate of the Pallas parity tests."""
    got, ref = np_(got), np_(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def random_variables(shapes, seed: int, dtype=np.float32):
    """Seeded values for a flax variables tree of these shapes (from
    `jax.eval_shape` of the module's init): kernels ~ N(0, 1 / fan_in),
    norm scales U(0.8, 1.2), means N(0, 0.1), variances U(0.5, 1.5), other
    leaves (biases, embeddings, packed attention) ~ N(0, 0.02) or, under a
    norm, N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("kernel", "in_proj_weight"):
            return rng.normal(0, np.sqrt(1.0 / np.prod(shape[:-1] if name == "kernel"
                                                        else shape[1:])), shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if name == "mean":
            return rng.normal(0, 0.1, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.05 if "bn" in str(path) or "norm" in str(path) else 0.02, shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(fill(p, s).astype(dtype)),
                                            shapes)
