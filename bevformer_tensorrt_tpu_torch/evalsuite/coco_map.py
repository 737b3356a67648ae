"""COCO-style 2D detection mAP in numpy (port of
`bevformer_tensorrt_tpu/evalsuite/coco_map.py`).

The reference's 2D family (YOLOX-x, CenterNet) evaluates through mmdet's
COCO wrapper (tools/2d/evaluate_*.py); pycocotools isn't a dependency here,
so this implements the metric definition directly: per-class greedy IoU
matching in descending-score order against 10 IoU thresholds .50:.05:.95,
101-point interpolated AP, averaged over classes and thresholds.

Boxes are [x1, y1, x2, y2] absolute pixels.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
N_RECALL_SAMPLES = 101


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix [len(a), len(b)] for xyxy boxes."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def _ap_single(
    gts: Dict[str, np.ndarray],  # image_id -> [n, 4]
    preds: List[Tuple[str, float, np.ndarray]],  # (image_id, score, box)
    iou_th: float,
) -> float:
    npos = sum(len(v) for v in gts.values())
    if npos == 0:
        return np.nan
    if not preds:
        return 0.0
    # pycocotools maxDets=100: keep each image's top-100 detections (by
    # score, stable) before the global sweep
    by_img: Dict[str, list] = defaultdict(list)
    for p in sorted(preds, key=lambda p: -p[1]):
        if len(by_img[p[0]]) < 100:
            by_img[p[0]].append(p)
    preds = sorted((p for v in by_img.values() for p in v), key=lambda p: -p[1])
    ious = {img: box_iou(np.array([p[2] for p in preds if p[0] == img]), g)
            for img, g in gts.items()}
    # greedy matching, one set of taken GT per image
    taken = defaultdict(set)
    tp = np.zeros(len(preds))
    per_img_counter = defaultdict(int)
    for k, (img, _, box) in enumerate(preds):
        g = gts.get(img)
        i = per_img_counter[img]
        per_img_counter[img] += 1
        if g is None or len(g) == 0:
            continue
        iou_row = ious[img][i]
        order = np.argsort(-iou_row)
        for j in order:
            if iou_row[j] < iou_th:
                break
            if j not in taken[img]:
                taken[img].add(j)
                tp[k] = 1.0
                break
    fp = 1.0 - tp
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1e-12)
    # COCO: precision envelope + 101-point interpolation
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    rec_interp = np.linspace(0, 1, N_RECALL_SAMPLES)
    idx = np.searchsorted(rec, rec_interp, side="left")
    prec_interp = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
    return float(prec_interp.mean())


def evaluate_coco_map(
    gt: Sequence[dict],
    pred: Sequence[dict],
    num_classes: int,
) -> Dict[str, float]:
    """gt/pred: dicts with image_id, category_id, bbox [x1,y1,x2,y2],
    (pred only) score. Returns {mAP, mAP_50, mAP_75}."""
    aps = np.full((num_classes, len(IOU_THRESHOLDS)), np.nan)
    for c in range(num_classes):
        gts: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros((0, 4)))
        for g in gt:
            if g["category_id"] == c:
                gts[g["image_id"]] = np.concatenate(
                    [gts[g["image_id"]], np.asarray(g["bbox"], np.float64).reshape(1, 4)]
                )
        preds = [
            (p["image_id"], float(p["score"]), np.asarray(p["bbox"], np.float64))
            for p in pred
            if p["category_id"] == c
        ]
        for t, th in enumerate(IOU_THRESHOLDS):
            aps[c, t] = _ap_single(dict(gts), preds, th)
    valid = ~np.isnan(aps)
    return {
        "mAP": float(np.nanmean(aps)) if valid.any() else 0.0,
        "mAP_50": float(np.nanmean(aps[:, 0])) if valid[:, 0].any() else 0.0,
        "mAP_75": float(np.nanmean(aps[:, 5])) if valid[:, 5].any() else 0.0,
    }
