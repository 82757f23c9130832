"""GaussianScene — the 3DGS parameter store as a small class of tensors.

Port of `gsattack/core/scene.py`. Per point, N = capacity:
  xyz            (N, 3)    world position
  f_dc           (N, 1, 3) SH DC coefficients
  f_rest         (N, K, 3) SH rest coefficients, K = (max_deg+1)^2 - 1
  log_scale      (N, 3)    log of per-axis scale (activation: exp)
  quat           (N, 4)    wxyz rotation (activation: normalise)
  opacity_logit  (N, 1)    opacity logit (activation: sigmoid)
  obj_dc         (N, 1, C_obj) object feature (C_obj = 16)
  alive          (N,) bool — False rows render fully transparent

Editing returns a new scene; the tensors of the old one are not touched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.knn import mean_knn_dist2
from . import sh as shlib
from .transforms import covariance6, inverse_sigmoid

NUM_OBJECTS = 16

PARAM_NAMES = (
    "xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit", "obj_dc",
)


@dataclasses.dataclass
class GaussianScene:
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    opacity_logit: torch.Tensor
    obj_dc: torch.Tensor
    alive: torch.Tensor
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        """Sigmoid opacity gated by the alive mask."""
        return torch.sigmoid(self.opacity_logit) * self.alive[:, None]

    @property
    def features(self) -> torch.Tensor:
        """(N, (D+1)^2, 3): DC and rest coefficients together."""
        return torch.cat([self.f_dc, self.f_rest], dim=1)

    def covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return covariance6(self.scaling, self.quat, scaling_modifier)

    def replace(self, **changes) -> "GaussianScene":
        return dataclasses.replace(self, **changes)

    def to(self, device: str | torch.device) -> "GaussianScene":
        """The same scene with its tensors on `device`."""
        return self.replace(**{name: getattr(self, name).to(device)
                               for name in PARAM_NAMES + ("alive",)})

    def oneup_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            return self.replace(active_sh_degree=self.active_sh_degree + 1)
        return self

    def concat(self, other: "GaussianScene") -> "GaussianScene":
        """Append another scene's points."""
        if self.max_sh_degree != other.max_sh_degree:
            raise ValueError("scenes of different max SH degree")
        fields = {
            name: torch.cat([getattr(self, name), getattr(other, name)], dim=0)
            for name in PARAM_NAMES + ("alive",)
        }
        return GaussianScene(
            **fields,
            active_sh_degree=max(self.active_sh_degree, other.active_sh_degree),
            max_sh_degree=self.max_sh_degree,
        )

    def compact(self) -> "GaussianScene":
        """Drop dead rows (the shape changes)."""
        keep = self.alive
        return self.replace(
            **{name: getattr(self, name)[keep] for name in PARAM_NAMES},
            alive=torch.ones(int(keep.sum()), dtype=torch.bool, device=self.device),
        )

    def pad_to(self, capacity: int) -> "GaussianScene":
        """Pad with dead points up to `capacity`."""
        pad = capacity - self.num_points
        if pad < 0:
            raise ValueError(f"capacity {capacity} < {self.num_points} points")
        if pad == 0:
            return self

        def padf(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])], dim=0)

        fields = {name: padf(getattr(self, name)) for name in PARAM_NAMES}
        fields["quat"][-pad:, 0] = 1.0  # identity rotation
        return self.replace(**fields, alive=padf(self.alive))

    def params(self) -> dict:
        """The differentiable parameters by name."""
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def with_params(self, p: dict) -> "GaussianScene":
        return self.replace(**p)


def scene_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int = 3,
    generator: Optional[torch.Generator] = None,
    knn_dist2: Optional[np.ndarray] = None,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """Initialise a scene from a point cloud (`create_from_pcd` semantics):
    f_dc = RGB2SH(colors), f_rest = 0, log_scale = log(sqrt(clamp_min(
    mean-3NN-dist^2, 1e-7))) per axis, identity rotation, opacity 0.1 and
    random object features RGB2SH(U[0, 1)) drawn from `generator`.

    `knn_dist2` (the mean squared 3-NN distance per point) is computed on
    `device` by `ops.knn.mean_knn_dist2` when it is None."""
    dev = resolve_device(device)
    if knn_dist2 is None:
        knn_dist2 = mean_knn_dist2(torch.as_tensor(np.asarray(points, np.float32), device=dev))
    n = points.shape[0]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dist2 = torch.clamp(torch.as_tensor(knn_dist2, dtype=torch.float32).cpu(), min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    k_rest = (max_sh_degree + 1) ** 2 - 1
    obj = shlib.rgb_to_sh(torch.rand((n, NUM_OBJECTS), generator=generator))
    quat = torch.zeros((n, 4), dtype=torch.float32)
    quat[:, 0] = 1.0
    f_dc = shlib.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32)))
    return GaussianScene(
        xyz=torch.as_tensor(np.asarray(points, np.float32)).to(dev),
        f_dc=f_dc[:, None, :].to(dev),
        f_rest=torch.zeros((n, k_rest, 3), dtype=torch.float32, device=dev),
        log_scale=log_scale.to(dev),
        quat=quat.to(dev),
        opacity_logit=torch.full(
            (n, 1), float(inverse_sigmoid(np.float32(0.1))), dtype=torch.float32,
            device=dev,
        ),
        obj_dc=obj[:, None, :].to(dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        active_sh_degree=0,
        max_sh_degree=max_sh_degree,
    )
