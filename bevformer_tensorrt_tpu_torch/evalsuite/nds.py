"""Self-contained nuScenes detection metric (mAP / TP errors / NDS)
(port of `bevformer_tensorrt_tpu/evalsuite/nds.py`, numpy only).

The reference wraps nuscenes-devkit (third_party/bev_mmdet3d/datasets/
nuscenes_eval.py:613-830 NuScenesEval_custom + devkit's DetectionEval); the
devkit isn't a dependency here, so this is an independent numpy
implementation of the published metric definition:

  * match predictions to GT greedily by descending score, on 2D ground-plane
    center distance, thresholds {0.5, 1, 2, 4} m
  * class-range filtering (per-class max eval distance)
  * AP = normalized area of the (precision - 0.1)+ curve over recall > 0.1,
    101-point interpolation
  * TP errors (ATE trans, ASE scale, AOE orient, AVE velocity, AAE attr)
    accumulated over matches at the 2 m threshold, averaged over the
    confidence sweep above min-recall
  * NDS = (5 * mAP + sum_tp (1 - min(1, err))) / 10

Box format everywhere: dict with
  translation (3,), size (w, l, h), rotation yaw (rad), velocity (2,),
  detection_name, detection_score, attribute_name (optional), sample_token.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

DETECTION_CLASSES = (
    "car",
    "truck",
    "bus",
    "trailer",
    "construction_vehicle",
    "pedestrian",
    "motorcycle",
    "bicycle",
    "traffic_cone",
    "barrier",
)

# devkit detection_cvpr_2019 config values
CLASS_RANGE = {
    "car": 50.0,
    "truck": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "construction_vehicle": 50.0,
    "pedestrian": 40.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
    "traffic_cone": 30.0,
    "barrier": 30.0,
}
DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_SAMPLES = 101

# classes for which a TP error is undefined (devkit LEAVES them out of the mean)
NO_VELOCITY = {"traffic_cone", "barrier"}
NO_ATTRIBUTE = {"traffic_cone", "barrier"}
NO_ORIENT = {"traffic_cone"}

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


@dataclasses.dataclass
class EvalBox:
    sample_token: str
    translation: np.ndarray  # (3,)
    size: np.ndarray  # (w, l, h)
    yaw: float
    velocity: np.ndarray  # (2,)
    detection_name: str
    detection_score: float = -1.0
    attribute_name: str = ""
    ego_translation: Optional[np.ndarray] = None  # (2,) box center - ego, xy

    @property
    def ego_dist(self) -> float:
        if self.ego_translation is None:
            return float(np.hypot(self.translation[0], self.translation[1]))
        return float(np.hypot(*self.ego_translation[:2]))


def center_distance(a: EvalBox, b: EvalBox) -> float:
    return float(np.hypot(a.translation[0] - b.translation[0], a.translation[1] - b.translation[1]))


def scale_iou(a: EvalBox, b: EvalBox) -> float:
    """IoU of the two boxes after aligning center+rotation (devkit scale_iou)."""
    mins = np.minimum(a.size, b.size)
    inter = float(np.prod(mins))
    union = float(np.prod(a.size)) + float(np.prod(b.size)) - inter
    return inter / max(union, 1e-12)


def yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def velocity_l2(a: EvalBox, b: EvalBox) -> float:
    return float(np.hypot(a.velocity[0] - b.velocity[0], a.velocity[1] - b.velocity[1]))


def attr_acc(pred: EvalBox, gt: EvalBox) -> float:
    if not gt.attribute_name:
        return np.nan
    return 1.0 if pred.attribute_name == gt.attribute_name else 0.0


def filter_by_range(boxes: Iterable[EvalBox]) -> List[EvalBox]:
    """devkit filter_eval_boxes: drop boxes beyond the per-class eval range."""
    return [b for b in boxes if b.ego_dist <= CLASS_RANGE.get(b.detection_name, 50.0)]


def _accumulate(
    gt_by_sample: Dict[str, List[EvalBox]],
    preds: List[EvalBox],
    class_name: str,
    dist_th: float,
    compute_tp: bool,
):
    """devkit `accumulate`: greedy matching in descending-score order."""
    npos = sum(
        1 for boxes in gt_by_sample.values() for b in boxes if b.detection_name == class_name
    )
    cls_preds = sorted(
        (p for p in preds if p.detection_name == class_name),
        key=lambda p: -p.detection_score,
    )
    if npos == 0 or not cls_preds:
        return None

    taken: set = set()
    tp, fp, conf = [], [], []
    errs = {m: [] for m in TP_METRICS}
    conf_tp: List[float] = []  # confidence at each TP (devkit match_data['conf'])
    for pred in cls_preds:
        best_dist, best_idx, best_gt = np.inf, None, None
        for i, gt in enumerate(gt_by_sample.get(pred.sample_token, ())):
            if gt.detection_name != class_name or (pred.sample_token, i) in taken:
                continue
            d = center_distance(pred, gt)
            if d < best_dist:
                best_dist, best_idx, best_gt = d, i, gt
        is_tp = best_dist < dist_th
        tp.append(1.0 if is_tp else 0.0)
        fp.append(0.0 if is_tp else 1.0)
        conf.append(pred.detection_score)
        if is_tp:
            taken.add((pred.sample_token, best_idx))
            if compute_tp:
                conf_tp.append(pred.detection_score)
                gt = best_gt
                errs["trans_err"].append(center_distance(pred, gt))
                errs["scale_err"].append(1.0 - scale_iou(pred, gt))
                period = np.pi if class_name == "barrier" else 2 * np.pi
                errs["orient_err"].append(
                    0.0 if class_name in NO_ORIENT else yaw_diff(pred.yaw, gt.yaw, period)
                )
                errs["vel_err"].append(
                    np.nan if class_name in NO_VELOCITY else velocity_l2(pred, gt)
                )
                errs["attr_err"].append(
                    np.nan if class_name in NO_ATTRIBUTE else 1.0 - attr_acc(pred, gt)
                )

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_RECALL_SAMPLES)
    prec_interp = np.interp(rec_interp, rec, prec, right=0)
    conf_interp = np.interp(rec_interp, rec, conf, right=0)

    out = {"recall": rec_interp, "precision": prec_interp, "confidence": conf_interp}
    if compute_tp:
        # devkit: cummean of the per-TP error, interpolated over the
        # CONFIDENCE curve (accumulate() interps match_data on 'conf', not
        # recall — np.interp needs ascending x, hence the reversals).
        conf_match = np.asarray(conf_tp, np.float64)
        for m in TP_METRICS:
            e = np.asarray(errs[m], np.float64)
            if len(e) == 0 or np.all(np.isnan(e)):
                # devkit cummean: all-NaN -> ones
                out[m] = np.ones(N_RECALL_SAMPLES)
            else:
                cum = np.divide(
                    np.nancumsum(e),
                    np.cumsum(~np.isnan(e)),
                    out=np.zeros(len(e)),
                    where=np.cumsum(~np.isnan(e)) != 0,
                )
                out[m] = np.interp(
                    conf_interp[::-1], conf_match[::-1], cum[::-1]
                )[::-1]
    return out


def _calc_ap(md) -> float:
    """devkit calc_ap: mean of (precision - 0.1)+ over the 90 recall samples
    above min_recall, normalized by (1 - min_precision)."""
    prec = np.copy(md["precision"])
    prec = prec[round((N_RECALL_SAMPLES - 1) * MIN_RECALL) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md, metric: str) -> float:
    """devkit calc_tp: mean of the error curve between min_recall and the
    max achieved recall (at the operating points with confidence > 0)."""
    if md is None:
        return 1.0
    first = round(MIN_RECALL * (N_RECALL_SAMPLES - 1)) + 1
    conf = md["confidence"]
    nonzero = np.nonzero(conf)[0]
    if len(nonzero) == 0:
        return 1.0
    last = int(nonzero.max())
    if last < first:
        return 1.0
    vals = md[metric][first : last + 1]
    vals = vals[~np.isnan(vals)]
    return float(np.mean(vals)) if len(vals) else 1.0


def evaluate_nuscenes(
    gt_boxes: Sequence[EvalBox],
    pred_boxes: Sequence[EvalBox],
    classes: Sequence[str] = DETECTION_CLASSES,
    verbose: bool = False,
) -> Dict[str, float]:
    """Full metric sweep. Returns {mAP, NDS, mATE, mASE, mAOE, mAVE, mAAE,
    per-class APs as 'AP_<class>'}."""
    gt_boxes = filter_by_range(gt_boxes)
    pred_boxes = filter_by_range(list(pred_boxes))

    gt_by_sample: Dict[str, List[EvalBox]] = defaultdict(list)
    for b in gt_boxes:
        gt_by_sample[b.sample_token].append(b)

    metrics: Dict[str, float] = {}
    aps = []
    tp_errs = {m: [] for m in TP_METRICS}
    for cls in classes:
        cls_aps = []
        for th in DIST_THRESHOLDS:
            md = _accumulate(gt_by_sample, pred_boxes, cls, th, compute_tp=(th == TP_DIST_THRESHOLD))
            cls_aps.append(_calc_ap(md) if md is not None else 0.0)
            if th == TP_DIST_THRESHOLD:
                for m in TP_METRICS:
                    skip = (
                        (m == "vel_err" and cls in NO_VELOCITY)
                        or (m == "attr_err" and cls in NO_ATTRIBUTE)
                        or (m == "orient_err" and cls in NO_ORIENT)
                    )
                    if not skip:
                        tp_errs[m].append(_calc_tp(md, m))
        ap = float(np.mean(cls_aps))
        metrics[f"AP_{cls}"] = ap
        aps.append(ap)
        if verbose:
            print(f"{cls}: AP {ap:.3f}")

    metrics["mAP"] = float(np.mean(aps)) if aps else 0.0
    tp_means = {}
    for m in TP_METRICS:
        tp_means[m] = float(np.mean(tp_errs[m])) if tp_errs[m] else 1.0
    metrics.update(
        mATE=tp_means["trans_err"],
        mASE=tp_means["scale_err"],
        mAOE=tp_means["orient_err"],
        mAVE=tp_means["vel_err"],
        mAAE=tp_means["attr_err"],
    )
    nds = (
        5.0 * metrics["mAP"]
        + sum(max(0.0, 1.0 - min(1.0, tp_means[m])) for m in TP_METRICS)
    ) / 10.0
    metrics["NDS"] = float(nds)
    return metrics


# mmdet3d's default-attribute heuristic (used when the head predicts no
# attributes — matches third_party/bev_mmdet3d output conversion)
DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "pedestrian": "pedestrian.standing",
    "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider",
}


def default_attribute(name: str, velocity: np.ndarray) -> str:
    """Velocity-aware default attr (mmdet3d NuScenesDataset._format_bbox)."""
    speed = float(np.hypot(velocity[0], velocity[1]))
    if speed > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    if name == "pedestrian":
        return "pedestrian.standing"
    return DEFAULT_ATTRIBUTES.get(name, "")
