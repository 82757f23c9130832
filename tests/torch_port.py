"""Helpers shared by the `test_torch_*` files: put one JAX scene / camera
through `gsattack_torch.convert` so both packages see the same inputs, and
compare gradients the way the Pallas parity tests do."""

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
