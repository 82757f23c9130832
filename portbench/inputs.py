"""Inputs made from `--seed`, on the device, in a few large calls: scenes,
cameras and detector weights. Both sides get the same tensors: the program
through its own types, the reference as plain dicts.

The scene is the repository's synthetic test scene (points N(0, diag of
`spread`^2) around `center`, colours U[0.05, 0.95], SH rest N(0, 0.02^2),
opacity logits N(0, 1), isotropic scales from a fixed squared 3-NN
distance, identity rotations, object features from U[0, 1)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import camera as refcam
from .reference.render import PARAM_NAMES, rgb_to_sh

NUM_OBJECTS = 16


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for one purpose (`salt`) of a run's seed;
    any seed up to 2**64 - 1 maps to its own stream."""
    mixed = (int(seed) * 1_000_003 + salt) % (2 ** 64)
    return torch.Generator(device=device).manual_seed(mixed)


def synthetic_scene(spec: dict, seed: int, device) -> dict:
    n, deg = spec["splats"], spec["sh_degree"]
    k_rest = (deg + 1) ** 2 - 1
    g = generator(seed, 1, device)
    normal = torch.randn((n, 3 + 1 + 3 * k_rest), generator=g, device=device)
    uniform = torch.rand((n, 3 + NUM_OBJECTS), generator=g, device=device)
    spread = torch.tensor(spec["spread"], device=device)
    center = torch.tensor(spec["center"], device=device)
    log_scale = math.log(math.sqrt(spec["knn_dist2"]))
    quat = torch.zeros((n, 4), device=device)
    quat[:, 0] = 1.0
    return {
        "xyz": normal[:, :3] * spread + center,
        "f_dc": rgb_to_sh(uniform[:, :3] * 0.9 + 0.05)[:, None, :],
        "f_rest": (normal[:, 4:] * spec["f_rest_std"]).reshape(n, k_rest, 3),
        "log_scale": torch.full((n, 3), log_scale, device=device),
        "quat": quat,
        "opacity_logit": normal[:, 3:4].contiguous(),
        "obj_dc": rgb_to_sh(uniform[:, 3:])[:, None, :],
        "alive": torch.ones(n, dtype=torch.bool, device=device),
    }


def mean_knn_dist2(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """(N,) mean squared distance of each point to its k nearest others."""
    sq = (points * points).sum(-1)
    out = torch.empty(points.shape[0], device=points.device)
    for lo in range(0, points.shape[0], chunk):
        p = points[lo:lo + chunk]
        d2 = (sq[lo:lo + chunk, None] - 2.0 * (p @ points.T) + sq[None]).clamp(min=0.0)
        out[lo:lo + chunk] = torch.topk(d2, k + 1, dim=1, largest=False).values[:, 1:].mean(-1)
    return out


def point_cloud_scene(points: torch.Tensor, colors: torch.Tensor, sh_degree: int, seed: int
                      ) -> dict:
    """A 3DGS initial scene from a point cloud: SH DC from the colours, no
    rest, isotropic scales sqrt of the mean squared 3-NN distance (at least
    1e-7), identity rotations, opacity 0.1, object features from U[0, 1)."""
    n, dev = points.shape[0], points.device
    k_rest = (sh_degree + 1) ** 2 - 1
    dist2 = torch.clamp(mean_knn_dist2(points), min=1e-7)
    quat = torch.zeros((n, 4), device=dev)
    quat[:, 0] = 1.0
    obj = torch.rand((n, NUM_OBJECTS), generator=generator(seed, 3, dev), device=dev)
    return {
        "xyz": points.contiguous(),
        "f_dc": rgb_to_sh(colors)[:, None, :].contiguous(),
        "f_rest": torch.zeros((n, k_rest, 3), device=dev),
        "log_scale": torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        "quat": quat,
        "opacity_logit": torch.full((n, 1), float(np.log(np.float32(0.1) / np.float32(0.9))),
                                    device=dev),
        "obj_dc": rgb_to_sh(obj)[:, None, :],
        "alive": torch.ones(n, dtype=torch.bool, device=dev),
    }


def pad_scene(scene: dict, capacity: int) -> dict:
    """`scene` padded with dead splats (zeros, identity rotation) to
    `capacity` rows."""
    pad = capacity - scene["xyz"].shape[0]
    out = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) for k, v in scene.items()}
    out["quat"][-pad:, 0] = 1.0
    return out


def program_scene(scene: dict, sh_degree: int, max_sh_degree: int):
    """The program's scene over the same tensors."""
    from gsattack_torch.core.scene import GaussianScene

    return GaussianScene(**{k: scene[k] for k in PARAM_NAMES}, alive=scene["alive"],
                         active_sh_degree=sh_degree, max_sh_degree=max_sh_degree)


def orbit_views(spec: dict) -> list:
    """(R, T) of the base camera and its yaw-turned copies, `step_deg`
    apart, as the program's `expand_viewpoints` makes them."""
    R0, T = np.eye(3), np.asarray(spec["camera_T"], np.float64)
    return [(refcam.yaw(R0, spec["yaw_step_deg"] * i) if i else R0, T)
            for i in range(spec["views"])]


def reference_cameras(views: list, spec: dict, device) -> list:
    return [refcam.make_camera(R, T, spec["fov"], spec["fov"] * spec["height"] / spec["width"],
                               spec["width"], spec["height"], device) for R, T in views]


def program_extrinsics(R, T, spec: dict):
    from gsattack_torch.core.camera import CameraExtrinsics

    return CameraExtrinsics(R, T, spec["fov"], spec["fov"] * spec["height"] / spec["width"],
                            spec["width"], spec["height"])


def detector_weights(model: torch.nn.Module, seed: int, device) -> None:
    """Every conv and linear weight of `model` ~ N(0, gain / fan_in) (gain 2
    for the convs with a frozen norm, the backbone's, else 1), biases 0,
    from one draw on the device; the norms keep their identity."""
    leaves = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    total = sum(m.weight.numel() for m in leaves)
    flat = torch.randn(total, generator=generator(seed, 2, device), device=device)
    at = 0
    with torch.no_grad():
        for m in leaves:
            w = m.weight
            gain = 2.0 if hasattr(m, "norm") else 1.0
            std = math.sqrt(gain / math.prod(w.shape[1:]))
            w.copy_(flat[at:at + w.numel()].view_as(w) * std)
            at += w.numel()
            if m.bias is not None:
                m.bias.zero_()
