"""detectron2 Faster R-CNN checkpoints into the port's `D2FasterRCNN`.

The reference loads `faster_rcnn_R_50_FPN_3x/model_final.pth`, a
detectron2 Checkpointer archive whose "model" entry is the flat state
dict; `load_flat_archive` unwraps it, and a flat .npz works too. The
port's module tree carries detectron2's names, so the archive loads key
for key. Dropped: the `pixel_mean` / `pixel_std` buffers and the anchor
generator's cell anchors (the port holds them as constants) and
`num_batches_tracked`. Every other key must match a module entry of the
same shape, and every module entry must be covered.
"""

from __future__ import annotations

from torch import nn

from .convert_common import load_flat_archive, load_state_strict

_SKIP_PREFIXES = ("pixel_mean", "pixel_std", "anchor_generator",
                  "proposal_generator.anchor_generator")


def load_into(model: nn.Module, path: str) -> None:
    """Load a detectron2 checkpoint (.pth Checkpointer archive, .pt, .npz)
    into a `D2FasterRCNN`."""
    load_state_strict(model, load_flat_archive(path),
                      lambda k: None if k.startswith(_SKIP_PREFIXES) else k)
