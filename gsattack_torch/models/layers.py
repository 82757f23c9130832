"""Pieces shared by the port's detectors: the frozen batch norm and the
seeded weight initialisation.

The detectors are frozen scoring heads: their weights never train, they
only pass gradients on to the image. So every norm runs on its stored
statistics, and the weights are made once, on the CPU, from an explicit
`torch.Generator`, then moved to the detector's device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """Batch norm on stored statistics: (x - mean) / sqrt(var + eps) *
    weight + bias per channel of an NCHW tensor. Its state entries are the
    upstream norms' `weight`, `bias`, `running_mean` and `running_var`
    (buffers: nothing here trains)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


def fan_in(weight: torch.Tensor) -> int:
    """Inputs per output of a conv (OIHW, I = c_in / groups) or linear
    (out, in) weight."""
    return int(math.prod(weight.shape[1:]))


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def init_dense(
    module: nn.Module, gen: torch.Generator, gain: Callable[[nn.Module], float] = lambda m: 1.0
) -> None:
    """Every conv and linear weight of `module` ~ N(0, gain(m) / fan_in)
    (the variance of flax's `lecun_normal` at gain 1, `he_normal` at 2),
    biases 0, in module order, from `gen`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, math.sqrt(gain(m) / fan_in(m.weight)), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def freeze(module: nn.Module, device: torch.device) -> nn.Module:
    """Move to `device`, evaluation mode, no parameter gradients."""
    return module.to(device).eval().requires_grad_(False)
