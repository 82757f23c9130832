"""Adaptive density control over a fixed capacity. Port of
`gsattack/train/densify.py`.

The scene keeps a capacity of slots with an `alive` mask: clone and split
children go into dead slots through a slot allocator (the lowest free
slots, in the order of their parents), pruning clears `alive`, and
`grow_capacity` pads the slots when children were dropped. The same
allocator moves the optimizer's moments, so a surviving point keeps its
Adam state and a new child starts from zero.

Semantics of the reference's density control:
  * stats: ||d mean2d|| summed over the steps a point was visible, its
    visit count, and the largest screen radius
  * clone: grad >= thresh and max scale <= percent_dense * extent
  * split: grad >= thresh and max scale > percent_dense * extent; 2
    children drawn from N(0, scale) rotated into the world, child scale =
    scale / 1.6; the parent is pruned
  * prune: opacity < min_opacity, or (with the screen-size limit)
    radii2D > max_screen_size or world scale > 0.1 * extent
  * opacity reset: logit(min(opacity, 0.01))
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..core.scene import GaussianScene
from ..core.transforms import inverse_sigmoid, quat_to_rotmat

N_SPLIT = 2


class DensifyStats(NamedTuple):
    xyz_gradient_accum: torch.Tensor  # (C,)
    denom: torch.Tensor  # (C,)
    max_radii2d: torch.Tensor  # (C,)

    @staticmethod
    def zeros(capacity: int, device: str | torch.device = "cpu") -> "DensifyStats":
        return DensifyStats(*(torch.zeros(capacity, device=device) for _ in range(3)))


def add_densification_stats(
    stats: DensifyStats,
    mean2d_grad: torch.Tensor,  # (C, 2) d loss / d screen-space mean
    radii: torch.Tensor,  # (C,) int
) -> DensifyStats:
    visible = radii > 0
    gnorm = torch.linalg.vector_norm(mean2d_grad, dim=-1)
    return DensifyStats(
        stats.xyz_gradient_accum + torch.where(visible, gnorm, 0.0),
        stats.denom + visible.to(torch.float32),
        torch.maximum(stats.max_radii2d, radii.to(torch.float32)),
    )


def _scatter_children(params: dict, alive: torch.Tensor, want: torch.Tensor, child: dict):
    """Place one child for each `want` slot into the free (dead) slots: the
    k-th wanted child takes the k-th free slot in slot order. Children
    past the last free slot are dropped. Returns (params, alive,
    number dropped)."""
    free_slots = torch.nonzero(~alive)[:, 0]
    child_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    placed = want & (child_rank < free_slots.shape[0])
    dest = free_slots[child_rank[placed]]
    new_params = {}
    for name, cur in params.items():
        out = cur.clone()
        out[dest] = child[name][placed]
        new_params[name] = out
    alive = alive.clone()
    alive[dest] = True
    dropped = int((want & ~placed).sum())
    return new_params, alive, dropped


def _row_mask(mask: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Broadcast a (C,) bool mask over the trailing dims of arr (C, ...)."""
    return mask.reshape((-1,) + (1,) * (arr.dim() - 1))


def densify_and_prune(
    scene: GaussianScene,
    stats: DensifyStats,
    generator: Optional[torch.Generator] = None,
    moments: Optional[Sequence[dict]] = None,
    max_grad: float = 2e-4,
    min_opacity: float = 0.005,
    extent: float = 1.0,
    percent_dense: float = 0.01,
    max_screen_size: float = 20.0,
    use_screen_limit: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> tuple[GaussianScene, DensifyStats, int, Optional[tuple]]:
    """One densification pass. Returns (scene, zeroed stats, number of
    children dropped, moments).

    The split children's N(0, 1) draws are `noise` (2, C, 3) when given,
    else drawn from `generator` on its device. `moments` (optional) is a
    sequence of per-parameter dicts (Adam's mu and nu) moved by the same
    allocator as the parameters: surviving points keep theirs, pruned
    slots and new children get zeros."""
    c = scene.num_points
    dev = scene.device
    if noise is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = torch.randn((N_SPLIT, c, 3), generator=generator, device=generator.device)
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    if tuple(noise.shape) != (N_SPLIT, c, 3):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, want {(N_SPLIT, c, 3)}")
    grads = torch.nan_to_num(stats.xyz_gradient_accum / torch.clamp(stats.denom, min=1.0))
    scaling = scene.scaling
    max_scale = scaling.max(dim=-1).values
    hot = (grads >= max_grad) & scene.alive
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # Prune first: it frees slots for the children. Split parents go.
    prune = torch.sigmoid(scene.opacity_logit[:, 0]) < min_opacity
    if use_screen_limit:
        prune = prune | (stats.max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)
    prune = (prune | split_mask) & scene.alive
    alive = scene.alive & ~prune

    snapshot = scene.params()
    params = dict(snapshot)
    dropped = 0

    # The moments ride along under prefixed keys, so that one allocator
    # pass moves parameters and moments together; pruned slots' moments
    # are zeroed and children's start at zero.
    moment_keys = []
    if moments is not None:
        for mi, tree in enumerate(moments):
            for k, v in tree.items():
                mk = f"__m{mi}.{k}"
                params[mk] = torch.where(_row_mask(prune, v), 0.0, v)
                moment_keys.append(mk)

    def with_zero_moments(child):
        child = dict(child)
        for mk in moment_keys:
            child[mk] = torch.zeros_like(params[mk])
        return child

    # Clone wave: copies of the parents as they were before this pass.
    params, alive, d0 = _scatter_children(params, alive, clone_mask, with_zero_moments(snapshot))
    dropped += d0

    # Split waves: children drawn around the parent.
    rot = quat_to_rotmat(snapshot["quat"])  # (C, 3, 3)
    for i in range(N_SPLIT):
        child = dict(snapshot)
        child["xyz"] = torch.einsum("nij,nj->ni", rot, noise[i] * scaling) + snapshot["xyz"]
        child["log_scale"] = torch.log(scaling / (0.8 * N_SPLIT))
        params, alive, di = _scatter_children(params, alive, split_mask, with_zero_moments(child))
        dropped += di

    new_moments = None
    if moments is not None:
        new_moments = tuple(
            {k: params.pop(f"__m{mi}.{k}") for k in tree} for mi, tree in enumerate(moments)
        )
    out = scene.with_params(params).replace(alive=alive)
    return out, DensifyStats.zeros(c, dev), dropped, new_moments


def reset_opacity(scene: GaussianScene) -> GaussianScene:
    """Opacity capped at 0.01 (the reference's `reset_opacity`)."""
    new = inverse_sigmoid(torch.clamp(torch.sigmoid(scene.opacity_logit), max=0.01))
    return scene.replace(opacity_logit=new)


def grow_capacity(
    scene: GaussianScene,
    stats: DensifyStats,
    factor: float = 1.5,
    moments: Optional[Sequence[dict]] = None,
    round_to: int = 1,
):
    """Grow the capacity by `factor` (rounded up to a multiple of
    `round_to`) when free slots ran out: dead slots are appended, stats
    and `moments` (if given) padded with zeros. Returns (scene, stats) or
    (scene, stats, moments)."""
    n = scene.num_points
    new_cap = int(n * factor)
    new_cap = ((new_cap + round_to - 1) // round_to) * round_to
    padded = scene.pad_to(new_cap)

    def pad(v):
        return torch.cat([v, v.new_zeros((new_cap - n,) + v.shape[1:])], dim=0)

    grown = DensifyStats(*(pad(v) for v in stats))
    if moments is None:
        return padded, grown
    return padded, grown, tuple({k: pad(v) for k, v in tree.items()} for tree in moments)
