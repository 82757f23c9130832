from .losses import (
    dssim_l1_loss,
    expon_lr_schedule,
    l1_loss,
    l2_loss,
    mse,
    psnr,
    ssim,
)

__all__ = [
    "l1_loss",
    "l2_loss",
    "mse",
    "psnr",
    "ssim",
    "dssim_l1_loss",
    "expon_lr_schedule",
]
