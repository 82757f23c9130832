"""Checkpoint and resume. Port of `gsattack/io/checkpoint.py`:

  1. PLY stays the interchange format (io/ply.py).
  2. The whole training state (parameters, Adam's moments and count, the
     densification stats, the step) is one `torch.save` of a flat dict of
     tensors and host values, `TrainState.state_dict()`, in a `step_{n}`
     directory. The JAX package's orbax checkpoints are not read.
  3. The `point_cloud/iteration_N/` directory convention and
     `searchForMaxIteration`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Save a `TrainState` under `path` (in `path/step_{step}` when `step`
    is given). Returns the checkpoint's directory."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    torch.save(state.state_dict(), os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(path: str, target=None):
    """The `TrainState` saved in the checkpoint directory `path`, on the
    device of `target` (a state) when one is given, else on the device it
    was saved from."""
    from ..train.trainer import TrainState

    device = None if target is None else target.scene.device
    flat = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=device, weights_only=True)
    return TrainState.from_state_dict(flat)


def latest_step_dir(root: str) -> Optional[str]:
    """The `step_{n}` directory of the largest n under `root`, if any."""
    if not os.path.isdir(root):
        return None
    steps = [
        (int(d.split("_")[-1]), d)
        for d in os.listdir(root)
        if d.startswith("step_") and d.split("_")[-1].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])


def save_scene_iteration(scene, model_path: str, iteration: int) -> str:
    """Write `point_cloud/iteration_N/point_cloud.ply` (the reference's
    scene-save convention)."""
    from .ply import save_scene_ply

    out = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    save_scene_ply(scene, out)
    return out


def load_scene_iteration(model_path: str, iteration: int = -1, max_sh_degree: int = 3,
                         device: str | torch.device = "cuda"):
    """Load a scene by iteration, -1 for the largest. Returns (scene,
    iteration)."""
    from .dataset import search_max_iteration
    from .ply import load_scene_ply

    pc_dir = os.path.join(model_path, "point_cloud")
    if iteration == -1:
        iteration = search_max_iteration(pc_dir)
    path = os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply")
    return load_scene_ply(path, max_sh_degree=max_sh_degree, device=device), iteration


def capture(trainer_state) -> dict:
    """The reference's `capture()`: parameters, densification stats,
    optimizer state and step, as a dict."""
    return {
        "scene": trainer_state.scene,
        "opt_state": {"mu": trainer_state.mu, "nu": trainer_state.nu,
                      "count": trainer_state.count},
        "stats": trainer_state.stats,
        "step": trainer_state.step,
    }


def restore(target_state, captured: dict):
    """Inverse of `capture`."""
    opt = captured["opt_state"]
    return dataclasses.replace(
        target_state, scene=captured["scene"], mu=opt["mu"], nu=opt["nu"],
        count=opt["count"], stats=captured["stats"], step=captured["step"],
    )
