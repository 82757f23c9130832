"""Ultralytics checkpoints into the port's YOLO graph.

The interchange is a flat tensor archive of the upstream state dict (a
torch-saved plain dict, or .npz), made on any machine with ultralytics:

    m = YOLO("yolov8n.pt").model
    torch.save(dict(m.state_dict()), "yolov8n_sd.pt")

`YoloGraph` carries the ultralytics module names, so the archive loads
key for key (`model.22.cv2.0.2.bias` is `YoloGraph.model[22].cv2[0][2]`'s
bias). Dropped: the DFL's fixed `arange` conv (the port takes the
expectation directly) and `num_batches_tracked`. Every other key must
match a module entry of the same shape, and every module entry must be
covered.
"""

from __future__ import annotations

from torch import nn

from .convert_common import load_flat_archive, load_state_strict


def _rename(key: str) -> str | None:
    if ".dfl." in key:
        return None
    return "model." + key if key[0].isdigit() else key


def load_into(model: nn.Module, path: str) -> None:
    """Load a flat ultralytics archive (.npz, .pt) into a `YoloGraph`."""
    load_state_strict(model, load_flat_archive(path), _rename)
