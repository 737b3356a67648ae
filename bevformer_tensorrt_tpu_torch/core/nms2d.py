"""Axis-aligned 2D NMS on the host for the 2D family (port of
`bevformer_tensorrt_tpu/core/nms2d.py`).

Replaces mmdet's multiclass_nms of the reference's YOLOX / CenterNet
deployment (test_cfg nms iou_threshold 0.65 / 0.5).  `multiclass_nms` runs
the native greedy loop (`native.nms_2d_native`, which raises if it cannot
be built); `nms` is the same loop in numpy, kept as the plain version the
tests hold the native one against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..native import nms_2d_native


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS on xyxy boxes; returns the kept indices, highest score
    first."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def multiclass_nms(boxes: np.ndarray, scores: np.ndarray, score_thr: float,
                   iou_threshold: float, max_per_img: int, nms_pre: int = 1000
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class NMS of boxes [P, 4] shared across the classes of scores
    [P, C]; returns (boxes [k, 4], scores [k], labels [k]).  `nms_pre` caps
    each class's candidates by score before the greedy loop (mmdet's
    convention: the loop is O(kept x candidates), and a noisy score map can
    push tens of thousands of candidates into it)."""
    out_b, out_s, out_l = [], [], []
    for c in range(scores.shape[1]):
        sc = scores[:, c]
        m = sc > score_thr
        if not m.any():
            continue
        b, s = boxes[m], sc[m]
        if nms_pre and len(s) > nms_pre:
            top = np.argpartition(-s, nms_pre)[:nms_pre]
            b, s = b[top], s[top]
        keep = nms_2d_native(b, s, iou_threshold)
        out_b.append(b[keep])
        out_s.append(s[keep])
        out_l.append(np.full(len(keep), c, np.int64))
    if not out_b:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
    b, s, l = np.concatenate(out_b), np.concatenate(out_s), np.concatenate(out_l)
    order = np.argsort(-s)[:max_per_img]
    return b[order], s[order], l[order]
