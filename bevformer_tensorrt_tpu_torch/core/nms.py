"""Rotated BEV NMS + Scale-NMS (host-side numpy; a copy of
`bevformer_tensorrt_tpu/core/nms.py`).

TPU-native replacement for the reference's iou3d CUDA extension
(third_party/bev_mmdet3d/ops/iou3d — boxes_iou_bev / nms_gpu) used by
CenterPoint post-processing, plus BEVDet's Scale-NMS (test_cfg
nms_rescale_factor in configs/bevdet/bevdet-r50-cbgs.py:168-171): each
class's boxes are scaled by a per-class factor before rotated-IoU NMS so
small/thin classes suppress correctly.

Rotated IoU via polygon clipping (Sutherland–Hodgman) — exact, pure numpy.
In the port this NMS is the tests' oracle: the evaluator's post-process
passes the native one (`native.nms_rotated_native`, `csrc/nms_rotated.cpp`)
to `scale_nms` as `nms`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _box_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, l, yaw) -> [N, 4, 2] corner polygons (ccw)."""
    cx, cy, w, l, yaw = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
    dx = np.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    dy = np.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x = cx[:, None] + c * dx - s * dy
    y = cy[:, None] + s * dx + c * dy
    return np.stack([x, y], axis=-1)


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip `subject` polygon by convex `clip` polygon."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        inp, out = out, []
        if not inp:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        for j in range(len(inp)):
            cur, nxt = inp[j], inp[(j + 1) % len(inp)]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
            if cin != nin:
                d = nxt - cur
                denom = edge[0] * d[1] - edge[1] * d[0]
                if abs(denom) > 1e-12:
                    t = (edge[0] * (a[1] - cur[1]) - edge[1] * (a[0] - cur[0])) / denom
                    out.append(cur + t * d)
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_iou_bev(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """IoU of two rotated BEV boxes [5] (cx, cy, w, l, yaw)."""
    pa = _box_corners(box_a[None])[0]
    pb = _box_corners(box_b[None])[0]
    inter_poly = _clip_polygon(pa, pb)
    inter = _polygon_area(inter_poly) if len(inter_poly) >= 3 else 0.0
    ua = box_a[2] * box_a[3] + box_b[2] * box_b[3] - inter
    return inter / max(ua, 1e-12)


def nms_rotated(boxes5: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS. boxes5 [N, 5]; returns kept indices."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes5), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order:
            if j == i or suppressed[j]:
                continue
            # cheap reject: center distance vs extent
            d = np.hypot(*(boxes5[i, :2] - boxes5[j, :2]))
            r = 0.5 * (max(boxes5[i, 2], boxes5[i, 3]) + max(boxes5[j, 2], boxes5[j, 3]))
            if d > r * 1.5:
                continue
            if rotated_iou_bev(boxes5[i], boxes5[j]) > iou_threshold:
                suppressed[j] = True
    return np.asarray(keep, np.int64)


def scale_nms(
    boxes9: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    iou_threshold: float = 0.2,
    rescale_factors: Sequence[float] = (1.0,) * 10,
    nms=nms_rotated,
) -> np.ndarray:
    """BEVDet Scale-NMS: per-class size rescale, then class-agnostic rotated
    NMS over all boxes (the reference applies one rotated NMS per task with
    rescaled dims; single-task config -> one pass).  `nms(boxes5, scores,
    iou_threshold)` is the rotated NMS: this module's, or the native one."""
    if len(boxes9) == 0:
        return np.zeros(0, np.int64)
    b5 = boxes9[:, [0, 1, 3, 4, 6]].copy()  # cx, cy, w, l, yaw
    f = np.asarray(rescale_factors, np.float64)[np.asarray(labels, np.int64)]
    b5[:, 2] *= f
    b5[:, 3] *= f
    return nms(b5, scores, iou_threshold)
