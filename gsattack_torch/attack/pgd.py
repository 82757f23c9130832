"""DAGGER PGD steps, the port of `gsattack/attack/pgd.py`.

  * **linf**: p <- p - alpha * sign(g) (targeted; `+` untargeted), then the
    perturbation is clamped elementwise into [-eps, eps] around the
    originals.
  * **l2**: a step along g / ||g||_2 (one norm over the whole tensor), then
    each point's delta row is projected onto the eps L2 ball, the
    semantics of torch's `renorm(p=2, dim=0, maxnorm=eps)`.
  * masked variants update only the points of a boolean mask.

On a device mesh each rank holds a block of points; `norm_group` (the
splats group) then sums the squared gradient over the blocks, so that the
l2 step's norm is the whole tensor's.

Each step is `(param, grad, original) -> param` and returns a new tensor.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..core.scene import GaussianScene
from ..parallel.collectives import all_reduce

# Attribute names of the reference -> GaussianScene fields.
ATTR_MAP = {
    "color": ("f_dc", "f_rest"),
    "position": ("xyz",),
    "rotation": ("quat",),
    "opacity": ("opacity_logit",),
    "scaling": ("log_scale",),
    "objects": ("obj_dc",),
}


def _masked(new, param, mask):
    if mask is None:
        return new
    m = mask.reshape((mask.shape[0],) + (1,) * (param.dim() - 1))
    return torch.where(m, new, param)


@torch.no_grad()
def linf_step(
    param: torch.Tensor,
    grad: torch.Tensor,
    original: torch.Tensor,
    alpha: float,
    epsilon: float,
    targeted: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    sign = -1.0 if targeted else 1.0
    new = param + sign * alpha * torch.sign(grad)
    new = original + torch.clamp(new - original, -epsilon, epsilon)
    return _masked(new, param, mask)


@torch.no_grad()
def l2_step(
    param: torch.Tensor,
    grad: torch.Tensor,
    original: torch.Tensor,
    alpha: float,
    epsilon: float,
    targeted: bool = True,
    mask: Optional[torch.Tensor] = None,
    norm_group=None,
) -> torch.Tensor:
    sign = -1.0 if targeted else 1.0
    if norm_group is None:
        gnorm = torch.linalg.vector_norm(grad.reshape(-1))
    else:
        gnorm = torch.sqrt(all_reduce(grad.square().sum(), norm_group))
    pos = gnorm > 0
    eta = sign * alpha * grad / torch.where(pos, gnorm, torch.ones_like(gnorm))
    new = param + torch.where(pos, eta, torch.zeros_like(eta))
    delta = new - original
    row_norm = torch.linalg.vector_norm(delta.reshape(delta.shape[0], -1), dim=1)
    scale = torch.where(
        row_norm > epsilon,
        epsilon / torch.clamp(row_norm, min=1e-20),
        torch.ones_like(row_norm),
    )
    new = original + delta * scale.reshape((-1,) + (1,) * (delta.dim() - 1))
    return _masked(new, param, mask)


def pgd_attack_step(
    scene: GaussianScene,
    grads: dict,
    originals: dict,
    alpha: float,
    epsilon: float,
    attributes: Iterable[str] = ("color",),
    norm: str = "l2",
    targeted: bool = True,
    mask: Optional[torch.Tensor] = None,
    norm_group=None,
) -> GaussianScene:
    """One PGD step over the selected attribute groups (any of color /
    position / rotation / opacity / scaling / objects). `originals` is the
    parameter dict taken at the start of the attack; `norm_group` as in
    the module docstring."""
    step = {"linf": linf_step, "l2": l2_step}[norm]
    kw = {"norm_group": norm_group} if norm == "l2" else {}
    params = scene.params()
    for attr in attributes:
        for field in ATTR_MAP[attr]:
            params[field] = step(
                params[field], grads[field], originals[field], alpha, epsilon,
                targeted=targeted, mask=mask, **kw,
            )
    return scene.with_params(params)


# -- named wrappers, the reference's public step-function surface ----------


def _mk(attr, norm):
    def fn(scene, grads, originals, alpha, epsilon, targeted=True, mask=None):
        return pgd_attack_step(
            scene, grads, originals, alpha, epsilon, (attr,), norm, targeted, mask
        )

    fn.__name__ = f"gaussian_{attr}_{norm}_attack"
    fn.__doc__ = f"PGD step on the {attr} attributes under the {norm} norm."
    return fn


gaussian_color_linf_attack = _mk("color", "linf")
gaussian_color_l2_attack = _mk("color", "l2")
gaussian_position_linf_attack = _mk("position", "linf")
gaussian_position_l2_attack = _mk("position", "l2")
gaussian_rotation_linf_attack = _mk("rotation", "linf")
gaussian_rotation_l2_attack = _mk("rotation", "l2")
gaussian_opacity_linf_attack = _mk("opacity", "linf")
gaussian_opacity_l2_attack = _mk("opacity", "l2")
gaussian_scaling_linf_attack = _mk("scaling", "linf")
gaussian_scaling_l2_attack = _mk("scaling", "l2")


def gaussian_color_linf_attack_masked(
    scene, grads, originals, alpha, epsilon, mask, targeted=True
):
    """Masked colour step: the mask applies to both the update and the
    projection."""
    return pgd_attack_step(
        scene, grads, originals, alpha, epsilon, ("color",), "linf", targeted, mask
    )
