"""COCO-style AP/AR evaluation — self-contained (no pycocotools): the
port's copy of `gsattack/evals/coco_ap.py`, numpy only.

Re-implements the slice of COCOeval the reference uses
(`utils/analyze_ap_ar.py:11-161`): bbox AP at configurable IoU thresholds
with 101-point interpolation and AR at a max-detections cap, plus the
render.log -> GT/DT JSON builder and the MiniCOCOeval-style concise
summary (AP@0.5 area=all maxDets=100, AR@0.5 maxDets=1).

Matching follows COCO: per image/category, detections sorted by score
greedily claim the unmatched GT with the highest IoU >= threshold.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

# `utils/analyze_ap_ar.py:90-97` — name -> COCO 80-class index.
CATEGORY_MAP = {
    "car": 2,
    "suitcase": 28,
    "toilet": 72,
    "tv": 64,
    "cell phone": 67,
    "stop sign": 11,
}


def _iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) xywh -> (D, G) IoU."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dt_xy = np.concatenate([dt[:, :2], dt[:, :2] + dt[:, 2:]], axis=1)
    gt_xy = np.concatenate([gt[:, :2], gt[:, :2] + gt[:, 2:]], axis=1)
    lt = np.maximum(dt_xy[:, None, :2], gt_xy[None, :, :2])
    rb = np.minimum(dt_xy[:, None, 2:], gt_xy[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = (dt[:, 2] * dt[:, 3])[:, None] + (gt[:, 2] * gt[:, 3])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


class COCOEvaluator:
    """Minimal bbox COCO evaluator over GT/DT dicts.

    gt: [{image_id, category_id, bbox [x,y,w,h]}]
    dt: [{image_id, category_id, bbox, score}]
    """

    def __init__(
        self,
        gt: Sequence[dict],
        dt: Sequence[dict],
        iou_thrs: Optional[Sequence[float]] = None,
        max_dets: Sequence[int] = (1, 10, 100),
    ):
        self.gt = list(gt)
        self.dt = list(dt)
        self.iou_thrs = (
            np.asarray(iou_thrs)
            if iou_thrs is not None
            else np.linspace(0.5, 0.95, 10)
        )
        self.max_dets = list(max_dets)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.cat_ids = sorted(
            {a["category_id"] for a in self.gt} | {d["category_id"] for d in self.dt}
        )
        self.img_ids = sorted(
            {a["image_id"] for a in self.gt} | {d["image_id"] for d in self.dt}
        )

    def _match(self, cat: int, max_det: int):
        """Global tp/fp arrays for one category at every IoU threshold."""
        t = len(self.iou_thrs)
        scores_all, tps_all = [], []
        n_gt = 0
        for img in self.img_ids:
            gts = [a for a in self.gt if a["image_id"] == img and a["category_id"] == cat]
            dts = [d for d in self.dt if d["image_id"] == img and d["category_id"] == cat]
            dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
            n_gt += len(gts)
            if not dts:
                continue
            ious = _iou_xywh(
                np.array([d["bbox"] for d in dts], float),
                np.array([a["bbox"] for a in gts], float).reshape(len(gts), 4),
            )
            tp = np.zeros((t, len(dts)), bool)
            for ti, thr in enumerate(self.iou_thrs):
                taken = np.zeros(len(gts), bool)
                for di in range(len(dts)):
                    best, best_iou = -1, thr
                    for gi in range(len(gts)):
                        if not taken[gi] and ious[di, gi] >= best_iou:
                            best, best_iou = gi, ious[di, gi]
                    if best >= 0:
                        taken[best] = True
                        tp[ti, di] = True
            scores_all.extend(d["score"] for d in dts)
            tps_all.append(tp)
        if scores_all:
            scores = np.asarray(scores_all)
            tps = np.concatenate(tps_all, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            tps = tps[:, order]
        else:
            tps = np.zeros((t, 0), bool)
        return tps, n_gt

    def _pr(self, tps: np.ndarray, n_gt: int):
        """Per-threshold (AP, max recall) from global sorted tp flags."""
        t, d = tps.shape
        ap = np.full(t, -1.0)
        rec = np.full(t, -1.0)
        if n_gt == 0:
            return ap, rec
        for ti in range(t):
            tp_cum = np.cumsum(tps[ti])
            fp_cum = np.cumsum(~tps[ti])
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            # COCO: precision envelope (monotone non-increasing), then sample
            # at the 101 recall thresholds.
            for i in range(d - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            idx = np.searchsorted(recall, self.rec_thrs, side="left")
            q = np.zeros(101)
            valid = idx < d
            q[valid] = precision[idx[valid]]
            ap[ti] = q.mean()
            rec[ti] = recall[-1] if d else 0.0
        return ap, rec

    def evaluate(self) -> dict:
        t = len(self.iou_thrs)
        ap = np.full((t, len(self.cat_ids)), -1.0)
        ar = {m: np.full((t, len(self.cat_ids)), -1.0) for m in self.max_dets}
        for ci, cat in enumerate(self.cat_ids):
            tps, n_gt = self._match(cat, max(self.max_dets))
            a, _ = self._pr(tps, n_gt)
            ap[:, ci] = a
            for m in self.max_dets:
                tps_m, n_gt_m = self._match(cat, m)
                _, r = self._pr(tps_m, n_gt_m)
                ar[m][:, ci] = r

        def mean_valid(x):
            v = x[x > -1]
            return float(v.mean()) if v.size else -1.0

        i50 = (
            int(np.argmin(np.abs(self.iou_thrs - 0.5)))
            if len(self.iou_thrs)
            else 0
        )
        return {
            "AP": mean_valid(ap),
            "AP50": mean_valid(ap[i50 : i50 + 1]),
            "AR_maxdets1": mean_valid(ar[self.max_dets[0]]),
            f"AR_maxdets{max(self.max_dets)}": mean_valid(ar[max(self.max_dets)]),
        }

    def selective_summarize(self) -> dict:
        """The MiniCOCOeval concise summary (`utils/analyze_ap_ar.py:11-87`):
        AP (area=all, maxDets=100) and AR (maxDets=1) at the configured IoU."""
        res = self.evaluate()
        iou_str = (
            f"{self.iou_thrs[0]:0.2f}:{self.iou_thrs[-1]:0.2f}"
            if len(self.iou_thrs) > 1
            else f"{self.iou_thrs[0]:0.2f}"
        )
        print(
            f" Average Precision  (AP) @[ IoU={iou_str:<9} | area=   all | "
            f"maxDets=100 ] = {res['AP']:0.3f}"
        )
        print(
            f" Average Recall     (AR) @[ IoU={iou_str:<9} | area=   all | "
            f"maxDets=  1 ] = {res['AR_maxdets1']:0.3f}"
        )
        return res


def build_coco_jsons(
    log_path: str,
    width: int,
    height: int,
    gt_json_path: str,
    dt_json_path: str,
    target_class: str,
    category_map: Optional[dict] = None,
) -> None:
    """render.log JSON-lines -> COCO GT + DT files
    (`utils/analyze_ap_ar.py:99-148`)."""
    category_map = category_map or CATEGORY_MAP
    with open(log_path) as f:
        entries = [
            json.loads(line.split(" - ")[-1]) for line in f if '"cam"' in line
        ]
    images, annotations, dt_results = [], [], []
    ann_id = 1
    seen = set()
    for e in entries:
        img_id = e["cam"]
        if img_id not in seen:
            seen.add(img_id)
            images.append(
                {"id": img_id, "width": width, "height": height, "file_name": ""}
            )
        gt_bbox = e.get("gt_bbox")
        if gt_bbox:
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": category_map[target_class],
                    "bbox": gt_bbox,
                    "area": gt_bbox[2] * gt_bbox[3],
                    "iscrowd": 0,
                }
            )
            ann_id += 1
        if (
            e.get("pred_class") != "None"
            and e.get("bbox")
            and e.get("confidence")
            and e.get("pred_category_id") is not None
        ):
            dt_results.append(
                {
                    "image_id": img_id,
                    "category_id": e["pred_category_id"],
                    "bbox": e["bbox"],
                    "score": float(e["confidence"]),
                }
            )
    with open(gt_json_path, "w") as f:
        json.dump(
            {
                "images": images,
                "annotations": annotations,
                "categories": [
                    {"id": cid, "name": name} for name, cid in category_map.items()
                ],
            },
            f,
        )
    with open(dt_json_path, "w") as f:
        json.dump(dt_results, f)


def run_coco_eval(gt_json_path: str, dt_json_path: str, iou_thr: float = 0.5) -> dict:
    """`run_coco_eval` (`utils/analyze_ap_ar.py:150-161`)."""
    with open(gt_json_path) as f:
        gt = json.load(f)["annotations"]
    with open(dt_json_path) as f:
        dt = json.load(f)
    ev = COCOEvaluator(gt, dt, iou_thrs=[iou_thr])
    return ev.selective_summarize()
