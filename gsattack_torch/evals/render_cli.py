"""Adversarial-render evaluation, the port of `gsattack/evals/render_cli.py`.

Per camera: render the attacked scene alone on black (its silhouette box
is the GT box), render it with the frozen overlay, run the detector with
`result_dict=True`, collect the COCO detections, and log one JSON record
through the `render` logger in the reference's schema:
  {"cam", "pred_class", "pred_category_id", "confidence", "bbox",
   "gt_bbox", "iou"}
(`evals/asr.py::load_preds` and `evals/coco_ap.py::build_coco_jsons` parse
it). With `save_images`, the renders are PNGs and the detections
`detections_coco.json` under timestamped `renders/%Y/%m/%d/%H/%M` dirs.

The renders run where the scene's tensors are: the blend's CUDA kernels
on a card, the plain version on the CPU. The port bins exactly the valid
pairs, so the reference's static caps resolve to none: -1 means exact,
and a positive pairs / tier budget raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from datetime import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from ..attack.silhouette import silhouette_bbox
from ..core.camera import CameraExtrinsics
from ..core.scene import GaussianScene
from ..io.png import to_uint8, write_png
from ..models.base import Detector
from ..ops.project import project
from ..ops.raster import auto_pairs_per_gaussian
from ..render import render

_PACK_ONLY = "ROADMAP.md Queue 1 item 6, the tiered bin and the auto_caps probes"


@dataclasses.dataclass
class RenderEvalConfig:
    target: Optional[int] = None
    untarget: Optional[int] = None
    is_targeted: bool = True
    attack_conf_thresh: float = 0.25
    white_background: bool = False
    renders_dir: str = "renders"
    preds_dir: str = "preds"
    save_images: bool = True
    # The reference's blend route ("auto", "xla" or "pallas"). Here the
    # route follows the tensors' device, so every value runs the same code.
    backend: str = "auto"
    # -1: sized from the largest tile footprint over (up to 8 of) the
    # cameras and every rendered scene.
    pairs_per_gaussian: int = -1
    rect_candidates: int = -1  # -1 means 0 (no row compaction)
    # The Pallas pack layout's and tiered bin's caps: -1 and 0 mean exact.
    pairs_budget: int = -1
    max_chunks: int = 16
    tier_split: int = -1
    heavy_budget: int = -1


def _resolve_render_caps(
    cfg: RenderEvalConfig,
    scenes: Sequence[GaussianScene],
    cameras: Sequence[CameraExtrinsics],
    log: logging.Logger,
) -> RenderEvalConfig:
    """Resolve the -1 settings: `pairs_per_gaussian` from the binned pair
    footprint of up to 8 sampled cameras over every scene that gets
    rendered (the target-only silhouette pass and the overlay pass); the
    rest to 0."""
    if cfg.backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    for field in ("pairs_budget", "tier_split", "heavy_budget"):
        if getattr(cfg, field) > 0:
            raise NotImplementedError(
                f"RenderEvalConfig.{field}={getattr(cfg, field)}: a static cap of the "
                f"Pallas pack layout and tiered bin, not ported ({_PACK_ONLY})"
            )
    pairs = cfg.pairs_per_gaussian
    rect = max(cfg.rect_candidates, 0)
    if pairs < 0:
        if len(cameras) > 8:
            sample = [cameras[i] for i in np.linspace(0, len(cameras) - 1, 8).astype(int)]
        else:
            sample = list(cameras)
        with torch.no_grad():
            pairs = max(
                auto_pairs_per_gaussian(project(sc, cam), cam.width, cam.height)
                for sc in scenes
                for cam in (ext.build(device=sc.device) for ext in sample)
            )
        log.info("[render-eval] auto caps: pairs_per_gaussian=%d rect_candidates=%d",
                 pairs, rect)
    return dataclasses.replace(
        cfg, pairs_per_gaussian=pairs, rect_candidates=rect, pairs_budget=0,
        tier_split=0, heavy_budget=0,
    )


def timestamped_dir(base: str, now: Optional[datetime] = None) -> str:
    now = now or datetime.now()
    return os.path.join(base, now.strftime("%Y/%m/%d/%H/%M"))


def run_render_eval(
    scene: GaussianScene,
    cameras: Sequence[CameraExtrinsics],
    detector: Detector,
    cfg: RenderEvalConfig,
    frozen_scene: Optional[GaussianScene] = None,
    logger: Optional[logging.Logger] = None,
) -> dict:
    """Returns {"records": [...], "coco": [...], "dirs": {...}}; each record
    is the logged one plus `success`."""
    log = logger or logging.getLogger("render")
    detector.load_model()
    dev = scene.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    black = torch.zeros(3, device=dev)
    now = datetime.now()
    render_dir = timestamped_dir(cfg.renders_dir, now)
    preds_dir = timestamped_dir(cfg.preds_dir, now)
    if cfg.save_images:
        os.makedirs(render_dir, exist_ok=True)
        os.makedirs(preds_dir, exist_ok=True)

    eval_scene = scene.concat(frozen_scene) if frozen_scene is not None else scene
    scenes = [scene] + ([eval_scene] if frozen_scene is not None else [])
    cfg = _resolve_render_caps(cfg, scenes, cameras, log)

    # with_objects=False: the eval never reads the 16 grouping channels.
    def render_rgb(sc, bg_, cam):
        out = render(sc, cam, bg_, pairs_per_gaussian=cfg.pairs_per_gaussian,
                     max_chunks=cfg.max_chunks, rect_candidates=cfg.rect_candidates,
                     with_objects=False)
        return out["render"], int(out["num_truncated_pairs"])

    records, coco_results = [], []
    n_truncated = 0
    for it, ext in enumerate(cameras):
        cam = ext.build(device=dev)
        with torch.no_grad():
            # GT silhouette box from the target-only scene on black.
            benign, trunc_b = render_rgb(scene, black, cam)
            bbox = silhouette_bbox(benign).cpu().numpy()
            combined, trunc_c = render_rgb(eval_scene, bg, cam)
        n_truncated += trunc_b + trunc_c
        if cfg.save_images:
            write_png(os.path.join(render_dir, f"render_{it}.png"), to_uint8(combined))

        success, result = detector.predict_and_save(
            image=combined,
            path=os.path.join(preds_dir, f"render_c{it}.png") if cfg.save_images else None,
            target=cfg.target,
            untarget=cfg.untarget,
            is_targeted=cfg.is_targeted,
            threshold=cfg.attack_conf_thresh,
            gt_bbox=bbox,
            result_dict=True,
            image_id=it,
        )
        if isinstance(result.get("detections"), list):
            coco_results.extend(result["detections"])
        closest = result["closest_class_name"] or "None"
        conf = result["closest_confidence"]
        structured = {
            "cam": it,
            "pred_class": closest,
            "pred_category_id": result.get("closest_category_id"),
            "confidence": f"{conf:.4f}" if isinstance(conf, (int, float)) else "None",
            "bbox": result.get("closest_bbox"),
            "gt_bbox": result.get("gt_bbox"),
            "iou": result.get("best_iou"),
        }
        log.info(json.dumps(structured))
        records.append({**structured, "success": bool(success)})

    if n_truncated:
        log.warning(
            "[render-eval] %d pairs truncated by the static caps across the "
            "sweep — raise max_chunks for exact images",
            n_truncated,
        )
    coco_path = None
    if cfg.save_images:
        coco_path = os.path.join(render_dir, "detections_coco.json")
        with open(coco_path, "w") as f:
            json.dump(coco_results, f)
    return {
        "records": records,
        "coco": coco_results,
        "dirs": {"renders": render_dir, "preds": preds_dir, "coco_json": coco_path},
    }
