"""Evaluation tools, the port of `gsattack/evals`: ASR and COCO AP over
render logs, the adversarial-render evaluation and the Gaussian-Grouping
renders."""

from .asr import analyze_asr_logs, compute_asr, load_preds, sweep_asr
from .coco_ap import (
    CATEGORY_MAP,
    COCOEvaluator,
    build_coco_jsons,
    run_coco_eval,
)
from .grouping import feature_to_rgb, render_grouping_set, visualize_obj
from .render_cli import RenderEvalConfig, run_render_eval, timestamped_dir

__all__ = [
    "load_preds",
    "compute_asr",
    "analyze_asr_logs",
    "sweep_asr",
    "COCOEvaluator",
    "CATEGORY_MAP",
    "build_coco_jsons",
    "run_coco_eval",
    "RenderEvalConfig",
    "run_render_eval",
    "timestamped_dir",
    "feature_to_rgb",
    "render_grouping_set",
    "visualize_obj",
]
