"""The DAGGER attack loop, the port of `gsattack/attack/dagger.py`: a host
loop around one render -> detector loss -> gradient -> PGD step per
iteration.

Kept from the reference: yaw-augmented extra cameras (7 deg * i),
truncation to a batch-size multiple, the per-batch iteration budget with
batch drop, the >= B-1 batch success rule, the `eval_every` throttle,
checkpoint/resume to `.npz`, the benign silhouette pass, and the
adversarial PLY on completion (`{output_dir}/{scene}_adv_{detector}.ply`).

The blend runs where the scene's tensors are: the CUDA kernels on a card,
the plain version on the CPU. With a (views, splats) `DeviceMesh`
(`parallel/`), every rank calls `run_dagger` with the whole scene; the
attack then runs on this rank's splat block and view block, and the
result is gathered whole on every rank.

Spans (`utils/profiling.py`): each PGD iteration is `pgd/iter`, with
`detector/loss`, `pgd/backward`, `pgd/step`, `pgd/loss_read` and `pgd/eval`
(the eval render, its copy to the host, and `detector/predict` for each
view) inside it, beside the render's own; the attack's set-up has
`dagger/caps` (the cap probe) and `dagger/benign` (the benign pass).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Camera, CameraExtrinsics, stack_cameras
from ..core.scene import GaussianScene
from ..models.base import Detector
from ..ops.project import project, stack_projections
from ..ops.raster import BACKENDS, CAP_FIELDS, TILE, rasterize_views, resolve_caps
from ..parallel.mesh import SPLATS_AXIS, VIEWS_AXIS, axis_size
from ..parallel.shard import (
    measure_tile_row_costs,
    plan_bands,
    render_sharded,
    render_views_sharded,
)
from ..parallel.shardings import gather_scene, shard_points, shard_scene
from ..render import render
from ..utils.profiling import annotate
from .pgd import pgd_attack_step
from .silhouette import silhouette_bbox


@dataclasses.dataclass
class AttackConfig:
    """Attack settings, the fields of the reference's `AttackConfig`, plus
    `chunk` (pairs per blend chunk; each tile blends at most
    `chunk * max_chunks` pairs)."""

    epsilon: float = 5.0
    alpha: float = 0.5
    max_iters: int = 100
    batch_mode: bool = True
    batch_size: int = 5
    attack_conf_thresh: float = 0.25
    is_targeted: bool = True
    target: Optional[int] = None
    untarget: Optional[int] = None
    attributes: tuple = ("color",)
    norm: str = "l2"
    add_cams: int = 0
    start_cam: Optional[int] = None
    end_cam: Optional[int] = None
    shift_amount: float = 0.15
    white_background: bool = False
    eval_every: int = 1
    scene_name: str = "scene"
    detector_name: str = "toy"
    output_dir: str = "output"
    preds_dir: Optional[str] = None  # save predict_and_save images when set
    # The static caps (ops/raster.py); -1 sizes each from the attack views
    # (and the eval overlay scene) as the reference does (`resolve_caps`).
    pairs_per_gaussian: int = 32
    max_chunks: int = 16
    chunk: int = 64
    # The reference's blend route ("xla" or "pallas"), with its rules for
    # the caps (`rasterize_views`); the blend follows the tensors' device.
    backend: str = "xla"
    pairs_budget: int = 0
    rect_candidates: int = 0
    compact_budget: int = 0
    tier_split: int = 0
    heavy_budget: int = 0
    save_ply: bool = True
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    resume: bool = False


@dataclasses.dataclass
class AttackResult:
    scene: GaussianScene
    success: bool
    iterations: int
    losses: list
    per_view_success: list
    adv_ply_path: Optional[str] = None


def render_views(
    scene: GaussianScene,
    cams: Camera,
    bg: torch.Tensor,
    pairs_per_gaussian: int = 32,
    max_chunks: int = 16,
    chunk: int = 64,
    rect_candidates: int = 0,
    with_objects: bool = True,
    mesh=None,
    band_tiles: tuple | None = None,
    backend: str = "xla",
    pairs_budget: int = 0,
    compact_budget: int = 0,
    tier_split: int = 0,
    heavy_budget: int = 0,
) -> torch.Tensor:
    """Multi-view render of a stacked camera -> (B, H, W, 3): the scene is
    projected once per view, and the batch is binned and blended in one
    launch (`rasterize_views`, whose `backend` rules apply the caps).

    With a (views, splats) `mesh`, every rank passes the whole scene and
    the same batch: the render runs sharded (`parallel/shard.py`) on this
    rank's block of the scene, padded with dead splats when the splats
    axis does not divide it, and the whole batch comes back on every
    rank, as does the whole scene's gradient. A batch that does not
    divide the views axis renders with views replicated."""
    caps = dict(backend=backend, pairs_budget=pairs_budget, compact_budget=compact_budget,
                tier_split=tier_split, heavy_budget=heavy_budget)
    if mesh is not None:
        return render_views_sharded(
            shard_scene(scene, mesh), cams, bg, mesh, pairs_per_gaussian, chunk, max_chunks,
            rect_candidates, band_tiles, with_objects, **caps,
        )
    proj = stack_projections([project(scene, cams.view_at(i)) for i in range(cams.num_views)])
    return rasterize_views(
        proj, cams.width, cams.height, bg,
        pairs_per_gaussian=pairs_per_gaussian, chunk=chunk, max_chunks=max_chunks,
        with_objects=with_objects, rect_candidates=rect_candidates, **caps,
    )["render"]


def expand_viewpoints(
    cameras: Sequence[CameraExtrinsics], add_cams: int
) -> list[CameraExtrinsics]:
    """Yaw-augmented extra viewpoints: camera 0 turned by 7 * i degrees."""
    out = list(cameras)
    for i in range(1, add_cams):
        out.append(cameras[0].yaw(7 * i))
    return out


def _check_supported(cfg: AttackConfig) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}")


def run_dagger(
    scene: GaussianScene,
    cameras: Sequence[CameraExtrinsics],
    detector: Detector,
    cfg: AttackConfig,
    frozen_scene: Optional[GaussianScene] = None,
    attack_mask: Optional[np.ndarray] = None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> AttackResult:
    """Run the DAGGER PGD attack on `scene` (the attacked splats), on the
    scene's device. `frozen_scene` (optional) is overlaid for the success
    evaluation render.

    With a (views, splats) `DeviceMesh`, every rank calls this with the
    same arguments. The scene, its originals and the mask shard over
    splats (padded with dead splats to a multiple of the axis), each
    camera batch over views; the tile bands are planned from measured
    pair costs; only rank 0 logs and writes files; the returned scene is
    the whole attacked scene on every rank."""
    _check_supported(cfg)
    detector.load_model()
    dev = scene.device
    lead = mesh is None or dist.get_rank() == 0  # the rank that logs and writes
    if not lead:
        log = lambda *_: None  # noqa: E731

    cameras = list(cameras)
    if cfg.start_cam is not None or cfg.end_cam is not None:
        cameras = cameras[cfg.start_cam : cfg.end_cam]
    views = expand_viewpoints(cameras, cfg.add_cams)
    if cfg.batch_mode and cfg.batch_size > 0:
        rem = len(views) % cfg.batch_size
        if rem:
            log(f"[Info] Truncating {rem} camera(s) to a batch_size multiple.")
            views = views[: len(views) - rem]
    batch_size = cfg.batch_size if cfg.batch_mode else 1
    num_batches = (
        math.ceil(len(views) / batch_size) if cfg.batch_mode and batch_size else 1
    )

    built = [v.build(device=dev) for v in views]
    if len({(c.width, c.height) for c in built}) > 1:
        raise ValueError("all attack views must share a resolution for batched rendering")

    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    black = torch.zeros(3, device=dev)
    if mesh is not None and batch_size % axis_size(mesh, VIEWS_AXIS):
        log(
            f"[Info] The view batch of {batch_size} does not divide the views axis "
            f"({axis_size(mesh, VIEWS_AXIS)}): views replicated, splats still sharded."
        )

    # The static caps: -1 sized from the real binned geometry, the max over
    # the attack views, and over the eval overlay scene too, whose pair
    # counts exceed the attacked sub-scene's.
    if min(getattr(cfg, k) for k in CAP_FIELDS) < 0:
        probe_scenes = [scene] + (
            [scene.concat(frozen_scene)] if frozen_scene is not None else []
        )
        with torch.no_grad(), annotate("dagger/caps"):
            views_probed = [(project(sc, c), c.width, c.height)
                            for sc in probe_scenes for c in built]
            caps = resolve_caps(views_probed, *(getattr(cfg, k) for k in CAP_FIELDS), log=log)
        del views_probed
        cfg = dataclasses.replace(cfg, **caps)

    # Pair-balanced tile bands for the sharded render: per-tile-row pair
    # costs over a sample of the attack views, split by the exact
    # linear-partition planner, so that a skewed scene (the object low in
    # the frame, an empty sky) does not leave most ranks waiting behind the
    # busiest equal-height band.
    band_tiles = None
    if mesh is not None:
        n_splats = axis_size(mesh, SPLATS_AXIS)
        if 1 < n_splats <= -(-built[0].height // TILE):
            sample = built[:: max(1, len(built) // 4)][:4]
            with torch.no_grad():
                costs = sum(
                    measure_tile_row_costs(project(scene, c), c.width, c.height,
                                           cfg.pairs_per_gaussian, cfg.rect_candidates)
                    for c in sample
                )
            band_tiles = plan_bands(costs, n_splats)
            log(f"[Info] Pair-balanced tile bands: {band_tiles}")

    # The attacked parameters: the whole scene's, or with a mesh this
    # rank's splat block (its L2 step norms summed over the splats group).
    full_points = scene.num_points
    base = scene if mesh is None else shard_scene(scene, mesh)
    norm_group = None if mesh is None else mesh.get_group(SPLATS_AXIS)
    originals = {k: v.detach().clone() for k, v in base.params().items()}
    mask = None if attack_mask is None else torch.as_tensor(attack_mask, device=dev)
    if mask is not None and mesh is not None:
        mask = shard_points(mask, mesh)

    # The caps each render takes, as the reference passes them: the loss
    # render all of them, the benign and eval renders (forward only) the
    # route and pairs_budget.
    loss_caps = dict(backend=cfg.backend, pairs_budget=cfg.pairs_budget,
                     compact_budget=cfg.compact_budget, tier_split=cfg.tier_split,
                     heavy_budget=cfg.heavy_budget)
    fwd_caps = dict(backend=cfg.backend, pairs_budget=cfg.pairs_budget)

    def views_render(sc, cams, background, caps):
        """The batch from this rank's parameters `sc`."""
        if mesh is not None:
            return render_views_sharded(
                sc, cams, background, mesh, cfg.pairs_per_gaussian, cfg.chunk,
                cfg.max_chunks, cfg.rect_candidates, band_tiles, **caps,
            )
        return render_views(
            sc, cams, background, cfg.pairs_per_gaussian, cfg.max_chunks,
            cfg.chunk, cfg.rect_candidates, **caps,
        )

    def whole(params):
        """The attacked scene, whole, from this rank's parameters."""
        sc = base.with_params(params)
        return sc if mesh is None else gather_scene(sc, mesh, full_points)

    # ---- benign pass: silhouette GT boxes on a black background
    gt_bboxes, n_trunc = [], 0
    with torch.no_grad(), annotate("dagger/benign"):
        for c in built:
            if mesh is None:
                out = render(
                    scene, c, black, pairs_per_gaussian=cfg.pairs_per_gaussian,
                    chunk=cfg.chunk, max_chunks=cfg.max_chunks,
                    rect_candidates=cfg.rect_candidates, **fwd_caps,
                )
                img = out["render"]
            else:
                out = render_sharded(
                    base, stack_cameras([c]), black, mesh, cfg.pairs_per_gaussian,
                    cfg.chunk, cfg.max_chunks, cfg.rect_candidates, band_tiles, **fwd_caps,
                )
                img = out["render"][0]
            gt_bboxes.append(silhouette_bbox(img).cpu().numpy())
            n_trunc += int(out["num_truncated_pairs"])
    gt_bboxes = np.stack(gt_bboxes)
    if n_trunc:
        log(
            f"[Warning] {n_trunc} valid pairs truncated by pairs_budget/max_chunks "
            "across the benign renders — images are missing contributions; raise "
            "pairs_budget or max_chunks."
        )

    target_idx = cfg.target if cfg.target is not None else 0

    def attack_step(params, cams, bboxes):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        sc = base.with_params(leaves)
        images = views_render(sc, cams, bg, loss_caps)
        with annotate("detector/loss"):
            loss = detector.loss(images, target_idx, bboxes)
        with annotate("pgd/backward"):
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
        grads = {
            k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()
        }
        with torch.no_grad(), annotate("pgd/step"):
            sc = pgd_attack_step(
                base.with_params(params), grads, originals, cfg.alpha,
                cfg.epsilon, cfg.attributes, cfg.norm, cfg.is_targeted, mask,
                norm_group=norm_group,
            )
        return sc.params(), loss.detach()

    def evaluate(params, cams, cur, cur_boxes, it):
        """The success check of the views `cur`: the eval render, brought
        to the host, and the detector's verdict on each view (rank 0's on
        every rank, so that every rank leaves the loop at the same
        iteration)."""
        with torch.no_grad():
            if frozen_scene is None:
                eval_imgs = views_render(base.with_params(params), cams, bg, fwd_caps)
            else:
                eval_imgs = render_views(
                    whole(params).concat(frozen_scene), cams, bg, cfg.pairs_per_gaussian,
                    cfg.max_chunks, cfg.chunk, cfg.rect_candidates, mesh=mesh,
                    band_tiles=band_tiles, **fwd_caps,
                )
        eval_imgs = eval_imgs.cpu().numpy()
        successes = []
        for j in range(len(cur)):
            path = (
                os.path.join(cfg.preds_dir, f"render_it{it}_c{j}.png")
                if cfg.preds_dir and lead
                else None
            )
            with annotate("detector/predict"):
                ok = detector.predict_and_save(
                    image=eval_imgs[j],
                    path=path,
                    target=cfg.target,
                    untarget=cfg.untarget,
                    is_targeted=cfg.is_targeted,
                    threshold=cfg.attack_conf_thresh,
                    gt_bbox=cur_boxes[j],
                )
            successes.append(bool(ok))
        if mesh is not None:
            box = [successes]
            dist.broadcast_object_list(box, src=0)
            successes = box[0]
        return successes

    params = {k: v.detach().clone() for k, v in base.params().items()}
    pending = list(range(len(built)))
    pending_boxes = list(gt_bboxes)
    losses: list[float] = []
    per_view_success: list[bool] = []
    it = 0
    start_it = 0
    all_done = False

    ckpt_path = (
        os.path.join(cfg.checkpoint_dir, "attack_state.npz") if cfg.checkpoint_dir else None
    )
    if cfg.resume and ckpt_path and os.path.exists(ckpt_path):
        with np.load(ckpt_path, allow_pickle=False) as z:
            params = {
                k[2:]: torch.as_tensor(z[k], device=dev) for k in z.files if k.startswith("p_")
            }
            if mesh is not None:
                params = shard_scene(scene.with_params(params), mesh).params()
            pending = [int(v) for v in z["pending"]]
            pending_boxes = list(z["pending_boxes"])
            start_it = int(z["iteration"]) + 1
            losses = [float(v) for v in z["losses"]]
        log(f"[resume] iteration {start_it}, {len(pending)} views pending")

    def save_ckpt(iteration):
        full = whole(params).params()  # every rank takes part in the gather
        if not lead:
            return
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        np.savez(
            ckpt_path,
            **{f"p_{k}": v.detach().cpu().numpy() for k, v in full.items()},
            pending=np.asarray(pending, np.int64),
            pending_boxes=np.asarray(pending_boxes if pending_boxes else np.zeros((0, 4))),
            iteration=iteration,
            losses=np.asarray(losses, np.float64),
        )

    for it in range(start_it, cfg.max_iters * num_batches):
        if cfg.batch_mode and not pending:
            break
        if cfg.batch_mode and (it + 1) % cfg.max_iters == 0:
            log(
                f"[Info] Per-batch budget of {cfg.max_iters} iterations hit; "
                "moving to next batch."
            )
            pending = pending[batch_size:]
            pending_boxes = pending_boxes[batch_size:]
            continue

        with annotate("pgd/iter"):
            cur = pending[:batch_size] if cfg.batch_mode else pending[:1]
            cur_boxes = np.stack(pending_boxes[: len(cur)])
            cams = stack_cameras([built[i] for i in cur])

            params, loss = attack_step(params, cams, cur_boxes)
            with annotate("pgd/loss_read"):
                losses.append(float(loss))
            log(f"Iteration: {it}, Loss: {losses[-1]}")

            if (it % cfg.eval_every) == 0:
                with annotate("pgd/eval"):
                    successes = evaluate(params, cams, cur, cur_boxes, it)
                n_ok = sum(successes)
                log(f"Successes: {n_ok}/{len(cur)}")
                if n_ok >= len(cur) - (1 if cfg.batch_mode and len(cur) > 1 else 0):
                    per_view_success.extend(successes)
                    pending = pending[len(cur) :]
                    pending_boxes = pending_boxes[len(cur) :]
                    if not pending:
                        all_done = True
                        log("All camera viewpoints attacked successfully")
                        break

        # Checkpoint after the success evaluation pruned `pending`, so a
        # resume does not replay views already recorded as successful.
        if ckpt_path and it > 0 and it % cfg.checkpoint_every == 0:
            save_ckpt(it)

    final = whole(params)
    ply_path = None
    if all_done and cfg.save_ply:
        from ..io.ply import save_scene_ply

        ply_path = os.path.join(cfg.output_dir, f"{cfg.scene_name}_adv_{cfg.detector_name}.ply")
        log(f"saving gaussians to {ply_path}")
        if lead:
            save_scene_ply(final, ply_path)
    return AttackResult(
        scene=final,
        success=all_done,
        iterations=it + 1,
        losses=losses,
        per_view_success=per_view_success,
        adv_ply_path=ply_path,
    )
