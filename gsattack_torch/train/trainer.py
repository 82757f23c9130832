"""The 3DGS training loop. Port of `gsattack/train/trainer.py`.

One training step renders one view (the tile blend at 19 channels: RGB
and the object features), takes the (1 - l) L1 + l (1 - SSIM) loss (plus
the 3D grouping regulariser when a classifier is given), differentiates
it with respect to every parameter and to a zero screen-space mean offset
(the mean2d tap that feeds the densification stats), and applies Adam
with the reference's per-group learning rates. Densify/prune, opacity
reset and the SH degree schedule run on the host between steps.

Spans (`utils/profiling.py`): a step is `train/step`, with `train/loss`,
`train/backward`, `train/adam`, `train/stats` and `train/loss_read` (the
loss brought to the host) inside it, beside the render's own; the
schedules are `train/sh`, `train/densify` and `train/reset`, each opened
only on the steps where it acts.

The blend runs where the scene's tensors are: the CUDA kernels on a card,
the plain version on the CPU. Hyperparameter defaults are the reference's
`OptimizationParams` and `configs/config.yaml`.

With a (views, splats) `DeviceMesh` (`parallel/`), every rank builds the
`Trainer` from the same whole scene. The per-point state (parameters,
Adam's moments, densify stats) is then this rank's block of the splats
axis, its capacity a multiple of the axis; a step renders through
`parallel.shard.render_sharded`. Densify gathers the state, runs the
single-device pass on every rank with the same draws, and keeps the
rank's block, so that the slot allocator stays global.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Camera, stack_cameras
from ..core.scene import PARAM_NAMES, GaussianScene
from ..device import resolve_device
from ..io.checkpoint import save_checkpoint
from ..ops.project import project
from ..ops.raster import BACKENDS, CAP_FIELDS, resolve_caps
from ..parallel.collectives import all_gather, gather
from ..parallel.mesh import SPLATS_AXIS, axis_size
from ..parallel.shard import render_sharded
from ..parallel.shardings import gather_scene, pad_to_multiple, shard_points, shard_scene
from ..render import render
from ..utils.losses import dssim_l1_loss, expon_lr_schedule
from ..utils.profiling import annotate, annotate_fn
from .densify import (
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    grow_capacity,
    reset_opacity,
)
from .reg3d import reg3d_loss

# optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15), as the reference trains.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
REG3D_SEED = 17


@dataclasses.dataclass
class TrainConfig:
    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    min_opacity: float = 0.005
    max_screen_size: float = 20.0
    white_background: bool = False
    sh_increase_interval: int = 1_000
    capacity_headroom: float = 1.5
    pairs_per_gaussian: int = 32
    max_chunks: int = 16
    # The reference's blend route ("xla" or "pallas"), with its rules for
    # the static caps (ops/raster.py); the blend follows the tensors'
    # device. Training grows the splat set: leave the caps headroom. A -1
    # is sized at `fit` from the training views (`resolve_caps`, as the
    # attack driver sizes it; the reference's trainer takes no -1).
    backend: str = "xla"
    pairs_budget: int = 0
    rect_candidates: int = 0
    compact_budget: int = 0
    tier_split: int = 0
    heavy_budget: int = 0
    spatial_lr_scale: float = 1.0
    # Gaussian Grouping's 3D consistency regulariser (train/reg3d.py), on
    # when a classifier head is given, every `reg3d_interval` steps.
    use_reg3d: bool = False
    reg3d_interval: int = 2
    reg3d_k: int = 5
    reg3d_lambda_val: float = 2.0
    reg3d_max_points: int = 300_000
    reg3d_sample_size: int = 1_000


@dataclasses.dataclass
class TrainState:
    """The scene, Adam's moments and shared step count, the densification
    stats, and the host step."""

    scene: GaussianScene
    mu: dict
    nu: dict
    count: int
    stats: DensifyStats
    step: int

    def to(self, device: str | torch.device) -> "TrainState":
        return TrainState(
            scene=self.scene.to(device),
            mu={k: v.to(device) for k, v in self.mu.items()},
            nu={k: v.to(device) for k, v in self.nu.items()},
            count=self.count,
            stats=DensifyStats(*(v.to(device) for v in self.stats)),
            step=self.step,
        )

    def state_dict(self) -> dict:
        """A flat dict of tensors and host values (the checkpoint)."""
        sc = self.scene
        flat = {f"scene.{k}": v for k, v in sc.params().items()}
        flat.update({"scene.alive": sc.alive, "scene.active_sh_degree": sc.active_sh_degree,
                     "scene.max_sh_degree": sc.max_sh_degree})
        flat.update({f"mu.{k}": v for k, v in self.mu.items()})
        flat.update({f"nu.{k}": v for k, v in self.nu.items()})
        flat.update({f"stats.{k}": v for k, v in zip(DensifyStats._fields, self.stats)})
        flat.update({"count": self.count, "step": self.step})
        return flat

    @staticmethod
    def from_state_dict(flat: dict) -> "TrainState":
        scene = GaussianScene(
            **{k: flat[f"scene.{k}"] for k in PARAM_NAMES},
            alive=flat["scene.alive"],
            active_sh_degree=int(flat["scene.active_sh_degree"]),
            max_sh_degree=int(flat["scene.max_sh_degree"]),
        )
        return TrainState(
            scene=scene,
            mu={k: flat[f"mu.{k}"] for k in PARAM_NAMES},
            nu={k: flat[f"nu.{k}"] for k in PARAM_NAMES},
            count=int(flat["count"]),
            stats=DensifyStats(*(flat[f"stats.{k}"] for k in DensifyStats._fields)),
            step=int(flat["step"]),
        )


def make_lr_tree(cfg: TrainConfig) -> Callable[[int], dict]:
    """Per-group learning rates at a step (`training_setup`): xyz on the
    exponential schedule scaled by the spatial extent, f_rest at
    feature_lr / 20."""
    xyz_sched = expon_lr_schedule(
        cfg.position_lr_init * cfg.spatial_lr_scale,
        cfg.position_lr_final * cfg.spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    )

    def lr_tree(step: int) -> dict:
        return {
            "xyz": xyz_sched(step),
            "f_dc": cfg.feature_lr,
            "f_rest": cfg.feature_lr / 20.0,
            "opacity_logit": cfg.opacity_lr,
            "log_scale": cfg.scaling_lr,
            "quat": cfg.rotation_lr,
            "obj_dc": cfg.feature_lr,
        }

    return lr_tree


def adam_update(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict):
    """One step of optax's `scale_by_adam` followed by p - lr * u: one
    shared count, bias correction at count + 1, computed in float32 as
    the reference does. Returns (params, mu, nu, count)."""
    count += 1
    bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(count))
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
        u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        new_p[k] = p - lrs[k] * u
        new_mu[k], new_nu[k] = m, v
    return new_p, new_mu, new_nu, count


def check_supported(cfg: TrainConfig) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}")


def image_tensor(image, device: torch.device) -> torch.Tensor:
    """An (H, W, 3) image (numpy or tensor) as a float32 tensor on
    `device`."""
    if isinstance(image, torch.Tensor):
        return image.to(device, torch.float32)
    return torch.tensor(np.asarray(image), dtype=torch.float32, device=device)


class Trainer:
    """Host loop around the training step, on `device` ("cuda" unless the
    caller asks for the CPU). With a `mesh`, `state` is this rank's block
    and `full_state()` the whole state (see the module docstring)."""

    def __init__(
        self,
        scene: GaussianScene,
        cfg: TrainConfig,
        cameras_extent: float = 1.0,
        classifier: Optional[tuple] = None,  # (weight (C, 16), bias (C,))
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cameras_extent = cameras_extent
        self.classifier = (
            tuple(torch.as_tensor(c, dtype=torch.float32, device=self.device) for c in classifier)
            if classifier is not None
            else None
        )
        capacity = int(scene.num_points * cfg.capacity_headroom)
        self.mesh = mesh
        self._splats = 1
        if mesh is not None:
            # Even blocks: capacity rounds up to the splats axis, here and
            # in every growth.
            self._splats = axis_size(mesh, SPLATS_AXIS)
            self._splats_group = mesh.get_group(SPLATS_AXIS)
            capacity = pad_to_multiple(capacity, self._splats)
        scene = scene.to(self.device).pad_to(capacity)
        params = scene.params()
        self.lr_tree = make_lr_tree(cfg)
        self.state = self._shard_state(TrainState(
            scene=scene,
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            count=0,
            stats=DensifyStats.zeros(capacity, self.device),
            step=0,
        ))
        # The largest count of pairs past a tile's blend cap in any step.
        self.max_truncated_pairs = torch.zeros((), dtype=torch.int64, device=self.device)

    def _shard_state(self, st: TrainState) -> TrainState:
        """This rank's block of a whole state (the state itself without a
        mesh)."""
        if self.mesh is None:
            return st
        block = lambda t: shard_points(t, self.mesh)  # noqa: E731
        return dataclasses.replace(
            st, scene=shard_scene(st.scene, self.mesh),
            mu={k: block(v) for k, v in st.mu.items()},
            nu={k: block(v) for k, v in st.nu.items()},
            stats=DensifyStats(*(block(v) for v in st.stats)),
        )

    def set_full_state(self, st: TrainState) -> None:
        """Continue from a whole state (on this trainer's device): with a
        mesh, this rank keeps its block; its capacity must divide by the
        splats axis."""
        if st.scene.num_points % self._splats:
            raise ValueError(f"capacity {st.scene.num_points} does not divide over "
                             f"{self._splats} splat ranks")
        self.state = self._shard_state(st)

    def full_state(self) -> TrainState:
        """The whole state on every rank (every rank must call it with a
        mesh); `state` without one."""
        st = self.state
        if self.mesh is None:
            return st
        whole = lambda t: all_gather(t, self._splats_group)  # noqa: E731
        return dataclasses.replace(
            st, scene=gather_scene(st.scene, self.mesh),
            mu={k: whole(v) for k, v in st.mu.items()},
            nu={k: whole(v) for k, v in st.nu.items()},
            stats=DensifyStats(*(whole(v) for v in st.stats)),
        )

    def _caps(self) -> dict:
        cfg = self.cfg
        return dict(backend=cfg.backend, pairs_budget=cfg.pairs_budget,
                    compact_budget=cfg.compact_budget, tier_split=cfg.tier_split,
                    heavy_budget=cfg.heavy_budget)

    def resolve_caps(self, cameras: Sequence[Camera], log: Callable[[str], None] = print,
                     sample: int = 8) -> None:
        """Size the config's -1 caps from the current scene's binned
        geometry over up to `sample` of `cameras` (`ops/raster.py
        resolve_caps`); `fit` calls it first. Nothing to do without a -1."""
        if min(getattr(self.cfg, k) for k in CAP_FIELDS) >= 0:
            return
        cams = list(cameras)
        if len(cams) > sample:
            cams = [cams[i] for i in np.linspace(0, len(cams) - 1, sample).astype(int)]
        scene = self.full_state().scene
        if self.mesh is not None and dist.get_rank() != 0:
            log = lambda *_: None  # noqa: E731
        with torch.no_grad():
            views = [(project(scene, c), c.width, c.height) for c in cams]
            caps = resolve_caps(views, *(getattr(self.cfg, k) for k in CAP_FIELDS), log=log)
        self.cfg = dataclasses.replace(self.cfg, **caps)

    @property
    def background(self) -> torch.Tensor:
        return torch.full((3,), 1.0 if self.cfg.white_background else 0.0, device=self.device)

    # ---- one training step -------------------------------------------------

    def loss_and_grads(self, camera: Camera, gt: torch.Tensor,
                       reg3d_idx: Optional[torch.Tensor] = None):
        """The step's loss on the current state and its gradients: returns
        (loss, parameter gradients by name, the mean2d gradient, the
        render's output dict). The grouping regulariser, when on, samples
        `reg3d_idx` if given, else a draw seeded by the step."""
        cfg, st = self.cfg, self.state
        leaves = {k: v.detach().requires_grad_(True) for k, v in st.scene.params().items()}
        offset = torch.zeros((st.scene.num_points, 2), device=self.device, requires_grad=True)
        sc = st.scene.with_params(leaves)
        if self.mesh is None:
            out = render(
                sc, camera, self.background, mean2d_offset=offset,
                pairs_per_gaussian=cfg.pairs_per_gaussian, max_chunks=cfg.max_chunks,
                rect_candidates=cfg.rect_candidates, **self._caps(),
            )
        else:
            out = render_sharded(
                sc, stack_cameras([camera]), self.background, self.mesh,
                pairs_per_gaussian=cfg.pairs_per_gaussian, max_chunks=cfg.max_chunks,
                rect_candidates=cfg.rect_candidates, mean2d_offset=offset, **self._caps(),
            )
            out = {**out, "render": out["render"][0], "radii": out["radii"][0]}
        with annotate("train/loss"):
            loss = self._loss(out["render"], gt, sc, reg3d_idx)
        with annotate("train/backward"):
            got = torch.autograd.grad(loss, [*leaves.values(), offset], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, got)}
        return loss.detach(), grads, got[-1], out

    def _loss(self, image: torch.Tensor, gt: torch.Tensor, sc: GaussianScene,
              reg3d_idx: Optional[torch.Tensor]) -> torch.Tensor:
        """L1 + D-SSIM of the render, plus the grouping regulariser on its
        steps."""
        cfg, st = self.cfg, self.state
        loss = dssim_l1_loss(image, gt, cfg.lambda_dssim)
        if cfg.use_reg3d and self.classifier is not None and st.step % cfg.reg3d_interval == 0:
            gen = None
            if reg3d_idx is None:
                gen = torch.Generator(device=self.device).manual_seed(REG3D_SEED * 1_000_003 + st.step)
            if self.mesh is not None:
                # The regulariser samples the whole scene: every rank
                # computes it on the gathered scene and keeps its block's
                # gradient.
                sc = sc.replace(alive=all_gather(sc.alive, self._splats_group), **{
                    k: gather(v, self._splats_group, 0, sum_grads=False)
                    for k, v in sc.params().items()
                })
            loss = loss + reg3d_loss(
                sc, *self.classifier, generator=gen, k=cfg.reg3d_k,
                sample_size=cfg.reg3d_sample_size, max_points=cfg.reg3d_max_points,
                lambda_val=cfg.reg3d_lambda_val, idx=reg3d_idx,
            )
        return loss

    @annotate_fn("train/step")
    def train_step(self, camera: Camera, gt: torch.Tensor,
                   reg3d_idx: Optional[torch.Tensor] = None) -> float:
        """One step: gradients, Adam at the learning rates of the current
        step, the densification stats. Returns the loss."""
        loss, grads, mean2d_grad, out = self.loss_and_grads(camera, gt, reg3d_idx)
        st = self.state
        with annotate("train/adam"):
            params, mu, nu, count = adam_update(
                st.scene.params(), grads, st.mu, st.nu, st.count, self.lr_tree(st.step)
            )
        self.max_truncated_pairs = torch.maximum(self.max_truncated_pairs,
                                                 out["num_truncated_pairs"])
        with annotate("train/stats"):
            stats = add_densification_stats(st.stats, mean2d_grad, out["radii"])
        self.state = TrainState(
            scene=st.scene.with_params(params), mu=mu, nu=nu, count=count,
            stats=stats, step=st.step + 1,
        )
        with annotate("train/loss_read"):
            return float(loss)

    # ---- host schedules ----------------------------------------------------

    def maybe_densify(self, iteration: int, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> None:
        """Densify and prune on the schedule, with Adam's moments moved by
        the same slot allocator; grow the capacity when children were
        dropped. The split draws are `noise` when given, else from
        `generator`."""
        cfg = self.cfg
        if not (
            cfg.densify_from_iter <= iteration <= cfg.densify_until_iter
            and iteration % cfg.densification_interval == 0
        ):
            return
        with annotate("train/densify"):
            st = self.full_state()
            scene, stats, dropped, moments = densify_and_prune(
                st.scene, st.stats, generator, moments=(st.mu, st.nu),
                max_grad=cfg.densify_grad_threshold, min_opacity=cfg.min_opacity,
                extent=self.cameras_extent, percent_dense=cfg.percent_dense,
                max_screen_size=cfg.max_screen_size,
                use_screen_limit=iteration > cfg.opacity_reset_interval, noise=noise,
            )
            if dropped > 0:
                scene, stats, moments = grow_capacity(scene, stats, cfg.capacity_headroom,
                                                      moments=moments, round_to=self._splats)
            self.state = self._shard_state(dataclasses.replace(
                st, scene=scene, mu=moments[0], nu=moments[1], stats=stats))

    def maybe_reset_opacity(self, iteration: int) -> None:
        """Opacity reset on the schedule; only the opacity group's moments
        are zeroed."""
        if iteration % self.cfg.opacity_reset_interval == 0 and iteration > 0:
            with annotate("train/reset"):
                st = self.state
                mu, nu = dict(st.mu), dict(st.nu)
                mu["opacity_logit"] = torch.zeros_like(mu["opacity_logit"])
                nu["opacity_logit"] = torch.zeros_like(nu["opacity_logit"])
                self.state = dataclasses.replace(st, scene=reset_opacity(st.scene),
                                                 mu=mu, nu=nu)

    def maybe_increase_sh(self, iteration: int) -> None:
        if iteration % self.cfg.sh_increase_interval == 0 and iteration > 0:
            with annotate("train/sh"):
                self.state = dataclasses.replace(self.state,
                                                 scene=self.state.scene.oneup_sh_degree())

    def fit(
        self,
        cameras: Sequence[Camera],
        gt_images: Sequence,
        iterations: Optional[int] = None,
        seed: int = 0,
        log: Callable[[int, float], None] = lambda i, l: None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1000,
    ) -> GaussianScene:
        """Train from the current step to `iterations`: a random view per
        step (a generator seeded by `seed` at each call, so a resumed run
        restarts the sampler), then the SH, densify and opacity-reset
        schedules. With `checkpoint_dir`, the whole state is saved every
        `checkpoint_every` steps (`io.checkpoint`; by rank 0 with a mesh).
        A -1 cap is sized first (`resolve_caps`). Returns the whole scene,
        on every rank."""
        iterations = iterations or self.cfg.iterations
        self.resolve_caps(cameras)
        views = torch.Generator().manual_seed(seed)
        noise = torch.Generator(device=self.device).manual_seed(seed)
        gts = [image_tensor(g, self.device) for g in gt_images]
        for it in range(self.state.step + 1, iterations + 1):
            vi = int(torch.randint(0, len(cameras), (1,), generator=views))
            loss = self.train_step(cameras[vi], gts[vi])
            log(it, loss)
            self.maybe_increase_sh(it)
            self.maybe_densify(it, noise)
            self.maybe_reset_opacity(it)
            if checkpoint_dir and it % checkpoint_every == 0:
                state = self.full_state()
                if self.mesh is None or dist.get_rank() == 0:
                    save_checkpoint(checkpoint_dir, state, step=it)
        return self.full_state().scene
