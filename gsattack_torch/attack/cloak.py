"""CLOAK: data poisoning through adversarial training views. Port of
`gsattack/attack/cloak.py`.

  1. `poison_image`: image-space linf PGD against a frozen detector's
     loss, targeted (make `target` appear on the object) or untargeted
     (make `untarget` go away).
  2. `run_cloak`: the poisoned images replace the training images of the
     chosen views, and the 3DGS trainer retrains the scene on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..core.scene import GaussianScene
from ..device import resolve_device
from ..models.base import Detector
from ..train.trainer import TrainConfig, Trainer, check_supported, image_tensor
from .silhouette import silhouette_bbox


@dataclasses.dataclass
class CloakConfig:
    epsilon: float = 16.0 / 255.0  # image-space linf budget
    alpha: float = 2.0 / 255.0
    steps: int = 40
    target: Optional[int] = None
    untarget: Optional[int] = None
    is_targeted: bool = True
    poison_view_indices: tuple = ()


def poison_image(
    image: torch.Tensor,
    detector: Detector,
    bbox,
    cfg: CloakConfig,
) -> torch.Tensor:
    """Image-space PGD on one (H, W, 3) view: a step of alpha by the sign
    of the loss's image gradient (down for a targeted attack, up for an
    untargeted one), then back into the linf ball of epsilon around the
    original and into [0, 1]."""
    detector.load_model()
    target_idx = int(cfg.target if cfg.is_targeted else cfg.untarget)
    sign = -1.0 if cfg.is_targeted else 1.0
    bboxes = np.asarray(bbox, np.float32).reshape(1, 4)
    orig = image.detach()
    img = orig
    for _ in range(cfg.steps):
        x = img.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(detector.loss(x[None], target_idx, bboxes), [x])
        img = img + sign * cfg.alpha * torch.sign(g)
        img = orig + torch.clamp(img - orig, -cfg.epsilon, cfg.epsilon)
        img = torch.clamp(img, 0.0, 1.0)
    return img.detach()


def run_cloak(
    init_scene: GaussianScene,
    cameras: Sequence[Camera],
    gt_images: Sequence,
    detector: Detector,
    cloak_cfg: CloakConfig,
    train_cfg: Optional[TrainConfig] = None,
    iterations: int = 2000,
    cameras_extent: float = 1.0,
    log: Callable[[str], None] = print,
    mesh=None,
    device: str | torch.device = "cuda",
) -> tuple[GaussianScene, list[torch.Tensor]]:
    """Poison the selected views (each against the silhouette box of its
    clean image) and retrain from `init_scene` on `device`. Returns (the
    retrained scene, the poisoned images).

    With a (views, splats) `DeviceMesh`, every rank calls this with the
    same arguments: each poisons the views, rank 0's poisoned images go
    to every rank, the retraining runs sharded (`Trainer(mesh=...)`) and
    only rank 0 logs."""
    train_cfg = train_cfg or TrainConfig()
    check_supported(train_cfg)
    dev = resolve_device(device)
    if mesh is not None and dist.get_rank() != 0:
        log = lambda *_: None  # noqa: E731
    images = [image_tensor(g, dev) for g in gt_images]
    poisoned = []
    for vi in cloak_cfg.poison_view_indices:
        bbox = silhouette_bbox(images[vi]).cpu().numpy()
        log(f"[cloak] poisoning view {vi} (bbox {bbox.tolist()})")
        images[vi] = poison_image(images[vi], detector, bbox, cloak_cfg)
        if mesh is not None:
            dist.broadcast(images[vi], src=0)
        poisoned.append(images[vi])
    log(f"[cloak] retraining for {iterations} iterations on {len(images)} views")
    trainer = Trainer(init_scene, train_cfg, cameras_extent=cameras_extent, mesh=mesh,
                      device=dev)
    scene = trainer.fit(list(cameras), images, iterations=iterations)
    return scene, poisoned
