"""The comparison that decides `correct`, shown to fail: a whole run of a
cell's traffic (the harness's look for a card skipped: the micro
configuration on the CPU, bfloat16 as the cells state) is correct as the
program stands, and comes out not correct
- under the control, the program's int8 path (`portbench/control.py` reads
  it on the card at the cells' sizes), and
- with the timed path broken underneath: a step that returns its state
  unchanged, half of the batch left out with the mean of the rest in its
  place (the fleet's lanes), and an answer altered where it is produced
  (two object queries' detections swapped in the head's output; the last
  decoder layer's class logits of one query moved by their spread
  across the queries), and the decoder's box refinement between layers left out.
The cells run on one card, so no exchange between cards exists to leave out.
"""
from __future__ import annotations

import json
import types
from pathlib import Path

import pytest
import torch

from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.models.heads.bevformer_head import BEVFormerHead
from bevformer_tensorrt_tpu_torch.models.modules.decoder import DetectionTransformerDecoder
from portbench import run

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parents[1]
SEED = 2 ** 32 + 77
SCALED = {  # the traffic mixes cut to the CPU: shorter scenes, fewer vehicles
    "stream": {"frames_per_scene": 6, "image_pool": 2, "check_depth": 4},
    "fleet": {"frames_per_scene": 6, "image_pool": 2, "check_depth": 4, "vehicles": 2,
              "batch": 2, "max_scenes": 4},
}
MICRO_LIMITS = json.loads((TESTS / "micro_limits.json").read_text())


def micro_cell(traffic: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = next(w["name"] for w in bench["workloads"] if w["traffic"] == traffic)
    params = json.loads((ROOT / "portbench" / "traffic" / f"{traffic}.json").read_text())
    return types.SimpleNamespace(
        name=name, chips=1, config=json.loads((TESTS / "micro.json").read_text()),
        params={**params, **SCALED[traffic]}, limits=MICRO_LIMITS[traffic],
        end_to_end=bench["end_to_end"], per_layer=[], root=ROOT)


def run_micro(traffic: str, **kw) -> dict:
    return run.run_cell(micro_cell(traffic), SEED, 5.0, False, torch.device("cpu"), **kw)


def state_unchanged(monkeypatch):
    forward, lanes = BEVFormer.forward, BEVFormer.forward_lanes

    def fwd(self, image, prev_bev, *rest):
        return (prev_bev, *forward(self, image, prev_bev, *rest)[1:])

    def fwd_lanes(self, images, prev_bev, *rest):
        return (prev_bev, *lanes(self, images, prev_bev, *rest)[1:])
    monkeypatch.setattr(BEVFormer, "forward", fwd)
    monkeypatch.setattr(BEVFormer, "forward_lanes", fwd_lanes)


def half_batch(monkeypatch):
    lanes = BEVFormer.forward_lanes

    def fwd_lanes(self, *args):
        outs = lanes(self, *args)
        half = outs[0].shape[0] // 2
        return tuple(torch.cat([t[:half], t[:half].mean(0, keepdim=True).expand_as(t[half:])])
                     for t in outs)
    monkeypatch.setattr(BEVFormer, "forward_lanes", fwd_lanes)


def answer_altered(monkeypatch):
    forward = BEVFormerHead.forward

    def fwd(self, *args):
        bev, classes, coords = forward(self, *args)
        swap = torch.tensor([1, 0])
        classes, coords = classes.clone(), coords.clone()
        classes[:, :, :2], coords[:, :, :2] = classes[:, :, swap], coords[:, :, swap]
        return bev, classes, coords
    monkeypatch.setattr(BEVFormerHead, "forward", fwd)


def last_layer_altered(monkeypatch):
    forward = BEVFormerHead.forward

    def fwd(self, *args):
        bev, classes, coords = forward(self, *args)
        classes = classes.clone()
        classes[-1, 0, 0] += classes[-1, 0].std(dim=0)
        return bev, classes, coords
    monkeypatch.setattr(BEVFormerHead, "forward", fwd)


def refinement_left_out(monkeypatch):
    forward = DetectionTransformerDecoder.forward

    def fwd(self, query, query_pos, value, reference_points, reg_branches):
        return forward(self, query, query_pos, value, reference_points,
                       lambda lid, x: 0.0 * reg_branches(lid, x))
    monkeypatch.setattr(DetectionTransformerDecoder, "forward", fwd)


@pytest.mark.parametrize("traffic", ["stream", "fleet"])
def test_sound_run_is_correct(traffic):
    res = run_micro(traffic)
    assert res["frames_checked"] >= 6
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("traffic", ["stream", "fleet"])
def test_control_is_not_correct(traffic):
    """The program's int8 path: at least one number over its limit, and by
    three times the sound run's reading."""
    sound = run_micro(traffic)["checks"]
    ctrl = run_micro(traffic, overrides={"quant": "int8"}, calibrate="max")
    assert not ctrl["correct"], ctrl["checks"]
    assert any(ctrl["checks"][k]["value"] >= 3 * sound[k]["value"] for k in sound)


@pytest.mark.parametrize("traffic, fault", [
    ("stream", state_unchanged), ("stream", answer_altered), ("stream", last_layer_altered),
    ("stream", refinement_left_out), ("fleet", state_unchanged), ("fleet", half_batch),
    ("fleet", answer_altered), ("fleet", refinement_left_out)])
def test_fault_is_not_correct(traffic, fault, monkeypatch):
    fault(monkeypatch)
    res = run_micro(traffic)
    assert res["frames_checked"] >= 6
    assert not res["correct"], res["checks"]
