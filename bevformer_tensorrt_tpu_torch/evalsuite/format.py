"""Detection-output -> EvalBox conversion for the NDS evaluator
(port of `bevformer_tensorrt_tpu/evalsuite/format.py`).

The reference converts lidar-frame boxes to nuScenes global frame via
pyquaternion (third_party/bev_mmdet3d/datasets/nuscenes_dataset.py:593-676
output_to_nusc_box + lidar_nusc_box_to_global) because devkit GT lives in
global coordinates.  Here GT comes from the same infos pkl in lidar frame,
and every term of the metric (center distance, scale IoU, yaw diff, velocity
diff) is invariant under the shared rigid transform — so predictions and GT
are compared directly in lidar frame.  Only the class-range filter is
ego-centered; the lidar->ego translation from the infos supplies that
offset.

Yaw convention: predictions and infos-GT share the mmdet3d LiDAR yaw, so no
-yaw - pi/2 flip (that flip exists in the reference only to enter the
nuScenes global convention for both sides; nuscenes_dataset.py:615).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.nuscenes import CLASSES
from .nds import EvalBox, default_attribute


def _ego_offset(info_like) -> np.ndarray:
    t = getattr(info_like, "lidar2ego_translation", None)
    if t is None and isinstance(info_like, dict):
        t = info_like.get("lidar2ego_translation")
    return np.asarray(t, np.float64)[:2] if t is not None else np.zeros(2)


def detections_to_eval_boxes(
    sample_token: str,
    det: Dict[str, np.ndarray],
    lidar2ego_translation: Optional[np.ndarray] = None,
    classes: Sequence[str] = CLASSES,
) -> List[EvalBox]:
    """det: NMSFreeCoder.decode() output {boxes_3d [n,9], scores_3d, labels_3d}."""
    off = (
        np.asarray(lidar2ego_translation, np.float64)[:2]
        if lidar2ego_translation is not None
        else np.zeros(2)
    )
    out = []
    for box, score, label in zip(det["boxes_3d"], det["scores_3d"], det["labels_3d"]):
        name = classes[int(label)]
        vel = np.asarray(box[7:9], np.float64)
        out.append(
            EvalBox(
                sample_token=sample_token,
                translation=np.asarray(box[:3], np.float64),
                size=np.asarray(box[3:6], np.float64),
                yaw=float(box[6]),
                velocity=vel,
                detection_name=name,
                detection_score=float(score),
                attribute_name=default_attribute(name, vel),
                ego_translation=np.asarray(box[:2], np.float64) + off,
            )
        )
    return out


def gt_to_eval_boxes(
    sample_token: str,
    gt_boxes: np.ndarray,   # [N, 9]
    gt_labels: np.ndarray,  # [N]
    lidar2ego_translation: Optional[np.ndarray] = None,
    classes: Sequence[str] = CLASSES,
) -> List[EvalBox]:
    off = (
        np.asarray(lidar2ego_translation, np.float64)[:2]
        if lidar2ego_translation is not None
        else np.zeros(2)
    )
    out = []
    for box, label in zip(np.asarray(gt_boxes), np.asarray(gt_labels)):
        name = classes[int(label)]
        vel = np.asarray(box[7:9], np.float64)
        out.append(
            EvalBox(
                sample_token=sample_token,
                translation=np.asarray(box[:3], np.float64),
                size=np.asarray(box[3:6], np.float64),
                yaw=float(box[6]),
                velocity=vel,
                detection_name=name,
                attribute_name=default_attribute(name, vel),
                ego_translation=np.asarray(box[:2], np.float64) + off,
            )
        )
    return out
