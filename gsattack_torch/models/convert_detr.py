"""The DETR demo checkpoint into the port's `DETRDemo`.

The reference pulls `detr_demo-da2a99e9.pth` from torch hub: the demo
model's flat state dict. The port's module tree carries its names
(`backbone.layer1.0.downsample.1.running_mean`,
`transformer.decoder.layers.0.multihead_attn.in_proj_weight`,
`query_pos`, ...), and the transformer is torch's own, so the archive
loads key for key; only `num_batches_tracked` is dropped. Every other key
must match a module entry of the same shape, and every module entry must
be covered.
"""

from __future__ import annotations

from torch import nn

from .convert_common import load_flat_archive, load_state_strict


def load_into(model: nn.Module, path: str) -> None:
    """Load the demo checkpoint (.pth, .pt, .npz) into a `DETRDemo`."""
    load_state_strict(model, load_flat_archive(path))
