"""Upstream checkpoints into the port's detectors: the flat tensor archive
reader and a strict state-dict load.

The port's detector modules carry the upstream module names (ultralytics
`model.{i}...`, detectron2 `backbone.bottom_up.res2.0.conv1...`, the DETR
demo's `backbone.layer1.0.bn1...`), so an upstream state dict loads with
`load_state_dict` after the keys the port has no module for are dropped.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn


def load_flat_archive(path: str) -> dict[str, np.ndarray]:
    """Read a flat tensor archive: .npz, or a torch-saved plain dict
    (a detectron2 Checkpointer archive's "model" entry is unwrapped)."""
    if path.endswith((".pt", ".pth")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
        return {k: np.asarray(v) for k, v in obj.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_state_strict(
    module: nn.Module,
    sd: Mapping[str, np.ndarray],
    rename: Callable[[str], str | None] = lambda k: k,
) -> None:
    """Load `sd` into `module`: `rename` maps each archive key to the
    module's key, or to None to drop it; `num_batches_tracked` is always
    dropped (the port's norms hold running statistics only). Every module
    key must be covered and every shape must match."""
    own = module.state_dict()
    state = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        name = rename(k)
        if name is None:
            continue
        if name not in own:
            raise ValueError(f"archive key {k!r} -> {name!r} is not in the module")
        t = torch.as_tensor(np.asarray(v, np.float32))
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch for {k}: archive {tuple(t.shape)}, module "
                             f"{tuple(own[name].shape)}")
        state[name] = t
    missing = sorted(set(own) - set(state))
    if missing:
        raise ValueError(f"{len(missing)} module entries not covered by the archive, "
                         f"e.g. {missing[:5]}")
    module.load_state_dict(state)
