"""Image losses and metrics: L1, L2, gaussian-window SSIM, MSE, PSNR, and
the exponential learning-rate schedule. Port of `gsattack/utils/losses.py`.

Images are (..., H, W, C) channel-last. The SSIM window filter is a
depthwise, zero-padded "same" convolution, run as two separable 1-D
passes (`F.conv2d`): the reference's banded matmuls are a TPU workaround
for the same filter.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error; per image, as a (B, 1) column, for a batch of
    (B, H, W, C) images."""
    if a.dim() > 3:
        return ((a - b) ** 2).reshape(a.shape[0], -1).mean(1, keepdim=True)
    return ((a - b) ** 2).mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = ((a - b) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))


def _gauss_window(window_size: int, sigma: float) -> np.ndarray:
    """The normalised 1-D gaussian window, computed in float64 and held in
    float32 as the reference's band matrix holds it."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM with a gaussian window (zero-padded "same" depthwise
    filtering). Accepts (H, W, C) or (B, H, W, C)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    x1 = img1.permute(0, 3, 1, 2)
    x2 = img2.permute(0, 3, 1, 2)
    c = x1.shape[1]
    # The five filtered maps in one depthwise pass per axis.
    stack = torch.cat([x1, x2, x1 * x1, x2 * x2, x1 * x2], dim=1)
    g = torch.as_tensor(_gauss_window(window_size, sigma), device=x1.device)
    half = window_size // 2
    groups = stack.shape[1]
    f = F.conv2d(stack, g.view(1, 1, -1, 1).expand(groups, 1, -1, 1).contiguous(),
                 padding=(half, 0), groups=groups)
    f = F.conv2d(f, g.view(1, 1, 1, -1).expand(groups, 1, 1, -1).contiguous(),
                 padding=(0, half), groups=groups)
    mu1, mu2, e11, e22, e12 = torch.split(f, c, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = e11 - mu1_sq
    s2 = e22 - mu2_sq
    s12 = e12 - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return ssim_map.mean()


def dssim_l1_loss(
    pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2
) -> torch.Tensor:
    """The 3DGS training objective: (1 - l) L1 + l (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt)
    )


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linear learning-rate decay with an optional sine-eased delay
    (`get_expon_lr_func`). The step is a host integer and the rate a
    Python float, computed in float32 as the reference computes it."""
    f32 = np.float32
    log_init, log_final = f32(math.log(max(lr_init, 1e-32))), f32(math.log(max(lr_final, 1e-32)))

    def helper(step: int) -> float:
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if step < 0:
            return 0.0
        s = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * np.clip(s / f32(lr_delay_steps), f32(0), f32(1))
            )
        else:
            delay_rate = f32(1)
        t = np.clip(s / f32(max_steps), f32(0), f32(1))
        return float(delay_rate * np.exp(log_init * (f32(1) - t) + log_final * t))

    return helper
