"""Gaussian Grouping's 3D object-feature regulariser. Port of
`gsattack/train/reg3d.py`: the classifier distributions of sampled points
are pulled toward those of their k nearest neighbours by a KL
consistency loss, so that splats close in space share object identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.scene import GaussianScene


def reg3d_loss(
    scene: GaussianScene,
    classifier_w: torch.Tensor,  # (C, 16)
    classifier_b: torch.Tensor,  # (C,)
    generator: Optional[torch.Generator] = None,
    k: int = 5,
    sample_size: int = 1000,
    max_points: int = 300_000,
    lambda_val: float = 2.0,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(p_neighbour || p_point) averaged over the sampled points and
    their k neighbours. The sample is `idx` when given, else
    min(sample_size, n) distinct points of the first n = min(points,
    max_points), drawn from `generator`."""
    n = min(scene.num_points, max_points)
    xyz = scene.xyz[:n]
    logits = scene.obj_dc[:n, 0, :] @ classifier_w.T + classifier_b  # (n, C)
    logp = F.log_softmax(logits, dim=-1)
    p = torch.exp(logp)

    if idx is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        m = min(sample_size, n)
        idx = torch.randperm(n, generator=generator, device=generator.device)[:m]
    idx = torch.as_tensor(idx, dtype=torch.int64).to(xyz.device)
    q = xyz[idx]  # (m, 3)
    d2 = (
        torch.sum(q * q, -1, keepdim=True)
        - 2.0 * q @ xyz.T
        + torch.sum(xyz * xyz, -1)[None, :]
    )
    # The k + 1 nearest, the first of them the point itself.
    kk = min(k + 1, n)
    nbr = torch.topk(-d2, kk, dim=1).indices[:, 1:]  # (m, k)
    logp_self = logp[idx][:, None, :]
    p_nbr = p[nbr]  # (m, k, C)
    logp_nbr = torch.log(torch.clamp(p_nbr, min=1e-12))
    kl = torch.sum(p_nbr * (logp_nbr - logp_self), dim=-1)  # (m, k)
    return lambda_val * kl.mean()
