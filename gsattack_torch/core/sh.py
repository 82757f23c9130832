"""Real spherical-harmonics evaluation for view-dependent splat colour.

Port of `gsattack/core/sh.py`: the same basis constants (degrees 0..4) and
the coefficient-major [..., K, C] evaluation.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _sh_basis(deg: int, dirs: torch.Tensor) -> list:
    """Coefficient-scaled SH basis factors at unit directions: a list of
    (deg+1)^2 tensors shaped [..., 1]."""
    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]
    basis = [C0 * torch.ones_like(x)]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
                if deg > 3:
                    basis += [
                        C4[0] * xy * (xx - yy),
                        C4[1] * yz * (3 * xx - yy),
                        C4[2] * xy * (7 * zz - 1),
                        C4[3] * yz * (7 * zz - 3),
                        C4[4] * (zz * (35 * zz - 30) + 3),
                        C4[5] * xz * (7 * zz - 3),
                        C4[6] * (xx - yy) * (7 * zz - 1),
                        C4[7] * xz * (xx - 3 * yy),
                        C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                    ]
    return basis


def eval_sh_features(deg: int, features: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH of degree `deg` in [0, 4] on coefficient-major
    [..., K, C] features at unit directions [..., 3] -> [..., C] (before
    the +0.5 shift)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} outside [0, 4]")
    if features.shape[-2] < num_sh_coeffs(deg):
        raise ValueError(
            f"{features.shape[-2]} SH coefficients < {num_sh_coeffs(deg)} "
            f"needed for degree {deg}"
        )
    basis = _sh_basis(deg, dirs)
    result = basis[0] * features[..., 0, :]
    for k in range(1, len(basis)):
        result = result + basis[k] * features[..., k, :]
    return result


def rgb_to_sh(rgb):
    """Inverse of the DC band: (rgb - 0.5) / C0."""
    return (rgb - 0.5) / C0


def sh_to_rgb_dc(sh):
    """The DC band alone: sh * C0 + 0.5."""
    return sh * C0 + 0.5
