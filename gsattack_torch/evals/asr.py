"""Attack Success Rate from paired benign/adversarial render logs: the
port's copy of `gsattack/evals/asr.py` (numpy-free, json only).

Same log contract as the reference (`utils/analyze_asr.py:6-56`): JSON
lines containing a "cam" record (logging prefix separated by ' - '), ASR =
#(benign==target and adv!=target) / #(benign==target).
"""

from __future__ import annotations

import json
import os
from typing import Optional


def load_preds(log_path: str) -> dict:
    """render.log -> {cam: pred_class or None}."""
    preds = {}
    with open(log_path) as f:
        for line in f:
            if '"cam"' not in line:
                continue
            entry = json.loads(line.split(" - ")[-1])
            cls = entry.get("pred_class")
            preds[entry["cam"]] = cls if cls != "None" else None
    return preds


def compute_asr(
    benign_preds: dict, adv_preds: dict, target_class: str
) -> tuple[int, int, float]:
    """(successful, total, asr)."""
    total = sum(1 for cls in benign_preds.values() if cls == target_class)
    successful = sum(
        1
        for cam, cls in benign_preds.items()
        if cls == target_class and adv_preds.get(cam) != target_class
    )
    return successful, total, (successful / total if total else 0.0)


def analyze_asr_logs(
    benign_log: str, adv_log: str, target_class: str
) -> Optional[dict]:
    if not (os.path.isfile(benign_log) and os.path.isfile(adv_log)):
        return None
    successful, total, asr = compute_asr(
        load_preds(benign_log), load_preds(adv_log), target_class
    )
    return {"successful": successful, "total": total, "asr": asr}


def sweep_asr(
    base_root: str,
    target_class: str,
    model_types: list[str],
    benign_sub_fmt: str,
    adv_sub_fmt: str,
    colors: list[str] = ("blue",),
) -> list[dict]:
    """Directory-sweep ASR over model x color ablations
    (`utils/analyze_asr.py:17-56`)."""
    results = []
    for model in model_types:
        for color in colors:
            benign_log = os.path.join(
                base_root, model, benign_sub_fmt.format(model=model, color=color),
                "render.log",
            )
            adv_log = os.path.join(
                base_root, model, adv_sub_fmt.format(model=model, color=color),
                "render.log",
            )
            r = analyze_asr_logs(benign_log, adv_log, target_class)
            if r is None:
                continue
            r.update({"model": model, "color": color})
            print(
                f"Model: {model}, Color: {color}, "
                f"ASR: {r['successful']}/{r['total']} = {r['asr']:.2%}"
            )
            results.append(r)
    return results
