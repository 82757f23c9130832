"""Device resolution shared by every constructor of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a constructor should build on. A CUDA device is returned
    only when a card is present: there is no quiet move to the CPU, the
    caller asks for it explicitly. On CUDA, TF32 is switched off for both
    matmuls and cuDNN convolutions: cuDNN runs float32 convolutions in TF32
    by default (about three decimal digits), which would break parity with
    the float32 reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA card is available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
