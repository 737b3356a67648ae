"""The PyTorch port's NDS evaluator and box conversion against the JAX
package's, and against the test-only transcription of the nuScenes devkit
(`tests/test_nds_devkit_oracle.py`), on the CPU.

Both evaluators are the same numpy code on float64 boxes, so the metrics
agree within 1e-12 (the devkit transcription, a different formulation, is
held to 1e-9 as in its own test).
"""
import dataclasses

import numpy as np
import pytest

from bevformer_tensorrt_tpu.evalsuite import format as jax_format
from bevformer_tensorrt_tpu.evalsuite import nds as jax_nds
from bevformer_tensorrt_tpu_torch.evalsuite import format, nds
from test_nds_devkit_oracle import _random_fixture, devkit_evaluate

METRICS = ("mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE", "mAAE")


def to_port(boxes):
    return [nds.EvalBox(**dataclasses.asdict(b)) for b in boxes]


def assert_metrics_equal(got, want, tol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=tol), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nds_matches_jax_and_the_devkit(seed):
    gt, preds = _random_fixture(seed)
    got = nds.evaluate_nuscenes(to_port(gt), to_port(preds))
    assert got["mAP"] > 0.05 and 0 < got["NDS"] < 1
    assert_metrics_equal(got, jax_nds.evaluate_nuscenes(gt, preds), 1e-12)
    want = devkit_evaluate(gt, preds)
    for k in METRICS + tuple(f"AP_{c}" for c in nds.DETECTION_CLASSES):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_nds_perfect_predictions_match_jax():
    gt, _ = _random_fixture(7)
    preds = [dataclasses.replace(b, detection_score=0.9) for b in gt]
    got = nds.evaluate_nuscenes(to_port(gt), to_port(preds))
    assert got["mAP"] > 0.9
    assert_metrics_equal(got, jax_nds.evaluate_nuscenes(gt, preds), 1e-12)
    assert got["NDS"] == pytest.approx(devkit_evaluate(gt, preds)["NDS"], abs=1e-9)


def test_nds_without_predictions_matches_jax():
    gt, _ = _random_fixture(3)
    assert_metrics_equal(nds.evaluate_nuscenes(to_port(gt), []),
                         jax_nds.evaluate_nuscenes(gt, []), 0.0)


def seeded_detections(rng, n):
    boxes = np.concatenate([
        rng.uniform(-60, 60, (n, 2)), rng.uniform(-3, 1, (n, 1)), rng.uniform(0.3, 5, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1)), rng.normal(0, 2, (n, 2))], axis=1).astype(np.float32)
    boxes[: n // 4, 7:9] = 0.05  # slow: the velocity-aware attributes' other branch
    return boxes, rng.uniform(0, 1, n).astype(np.float32), rng.integers(0, 10, n)


def assert_boxes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in dataclasses.fields(w):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field.name
            else:
                assert a == b, field.name


@pytest.mark.parametrize("offset", [None, (0.9, 0.0, 1.8)])
def test_box_conversion_matches_jax(rng, offset):
    boxes, scores, labels = seeded_detections(rng, 60)
    det = {"boxes_3d": boxes, "scores_3d": scores, "labels_3d": labels}
    assert_boxes_equal(format.detections_to_eval_boxes("s0", det, offset),
                       jax_format.detections_to_eval_boxes("s0", det, offset))
    assert_boxes_equal(format.gt_to_eval_boxes("s0", boxes, labels, offset),
                       jax_format.gt_to_eval_boxes("s0", boxes, labels, offset))
    names = {b.attribute_name for b in format.gt_to_eval_boxes("s0", boxes, labels)}
    assert {"vehicle.moving", "vehicle.parked"} <= names


def test_converted_boxes_evaluate_like_jax(rng):
    """Detections and GT through each package's conversion and evaluator:
    noisy copies of the GT, so the metrics are far from their floor."""
    gt, _, labels = seeded_detections(rng, 40)
    gt[:, :2] = rng.uniform(-25, 25, (40, 2))
    det = {"boxes_3d": gt + rng.normal(0, 0.3, gt.shape).astype(np.float32),
           "scores_3d": rng.uniform(0.1, 1, 40).astype(np.float32), "labels_3d": labels}
    gt_labels = labels.copy()
    got = nds.evaluate_nuscenes(format.gt_to_eval_boxes("s0", gt, gt_labels),
                                format.detections_to_eval_boxes("s0", det))
    want = jax_nds.evaluate_nuscenes(jax_format.gt_to_eval_boxes("s0", gt, gt_labels),
                                     jax_format.detections_to_eval_boxes("s0", det))
    assert got["mAP"] > 0.3
    assert_metrics_equal(got, want, 1e-12)
