"""The plain reference against the program on the CPU: the upstream-layout
weights load into the program strictly, the reference agrees with the
program's float32 forward over a scene's first two frames (which keeps the
copy faithful), and the FLOP counter counts what a hand count gives.

These tests import the program; the reference itself imports nothing of it
(`test_portbench_imports.py`)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.torch_import import load_bevformer_checkpoint
from portbench import run
from portbench.families import bevformer as family
from portbench.frames import Traffic
from portbench.record import Capture
from portbench.reference.model import Counter, Reference
from portbench.reference.weights import checkpoint_specs, seeded_checkpoint

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parents[1]
SEED = 2 ** 33 + 19
PARAMS = {"frames_per_scene": 3, "image_pool": 2}


def micro(name: str) -> dict:
    return json.loads((TESTS / name).read_text())


@pytest.mark.parametrize("name, offset_scale", [("micro.json", 0.03), ("micro_dcn.json", 0.03),
                                                ("micro_dcn.json", 1.0)])
def test_reference_agrees_with_the_program_in_float32(name, offset_scale):
    """Two frames of one scene (the second carries the first's BEV), then
    the next scene's first frame; the DCN configuration also with offsets of
    pixels (scale 1), where a wrong offset order would show.  Every decoder
    layer from the reference's own chain, and again from the program's
    layer outputs and reference points (the check's way), with the
    refinement of the program's points."""
    doc = micro(name)
    m = doc["model"]
    cfg = run.program_config(doc, {"dtype": "float32"})
    cpu = torch.device("cpu")
    w = seeded_checkpoint(m, SEED, cpu, offset_scale)
    engine = BEVFormerEngine(cfg, state_dict=load_bevformer_checkpoint(cfg, w), device="cpu")
    ref = Reference(w, m)
    traffic = Traffic(m, PARAMS, SEED, cpu)
    state, prev = family.TemporalState(), None
    for key in ((0, 0, 0), (0, 0, 1), (0, 1, 0)):
        fr = traffic.frame(*key)
        with Capture(engine.model) as capture:
            classes, coords = engine.infer_frame(fr["image"], fr["can_bus"], fr["lidar2img"],
                                                 fr["scene_token"])
        can_bus, use_prev = state.step(fr["can_bus"], fr["scene_token"])
        if not use_prev:
            prev = None
        inputs = (torch.as_tensor(fr["image"][0]), prev, use_prev, torch.as_tensor(can_bus),
                  torch.as_tensor(fr["lidar2img"][0]))
        with torch.no_grad():
            bev, r_classes, r_coords, _ = ref.frame(*inputs)
            _, f_classes, f_coords, refined = ref.frame(*inputs, given=capture.outputs[0])
        prev = bev
        got_bev = engine.state.prev_bev.reshape(bev.shape)
        assert family.bev_rel(got_bev, bev) < 1e-5, key
        for got, want in ((classes[:, 0], r_classes), (coords[:, 0], r_coords),
                          (classes[:, 0], f_classes), (coords[:, 0], f_coords),
                          (capture.outputs[0][1], refined)):
            assert got.shape == want.shape
            scale = want.abs().max()
            assert float((got - want).abs().max() / scale) < 1e-5, key


def test_upstream_weights_load_strictly():
    """Every tensor the program takes, under the upstream keys, and no other
    (`load_bevformer_checkpoint` raises on a missing or an unknown key)."""
    for name in ("micro.json", "micro_dcn.json"):
        doc = micro(name)
        cfg = run.program_config(doc, {})
        sd = seeded_checkpoint(doc["model"], SEED, torch.device("cpu"), 0.03)
        port = load_bevformer_checkpoint(cfg, sd)
        engine = BEVFormerEngine(cfg, state_dict=port, device="cpu")
        own = engine.model.state_dict()
        assert set(port) == set(own)
        for k, v in port.items():
            assert v.shape == own[k].shape, k


def test_seeded_weights_follow_the_rule():
    sd = seeded_checkpoint(micro("micro_dcn.json")["model"], SEED, torch.device("cpu"), 0.03)
    again = seeded_checkpoint(micro("micro_dcn.json")["model"], SEED, torch.device("cpu"), 0.03)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    w = sd["img_backbone.layer3.0.conv2.weight"]  # 64 * 2^2 planes, 3x3
    assert float(w.std()) == pytest.approx(1 / np.sqrt(256 * 9), rel=0.05)
    off = sd["img_backbone.layer3.0.conv2.conv_offset.weight"]
    assert float(off.std()) == pytest.approx(0.03 / np.sqrt(256 * 9), rel=0.1)
    assert float(sd["pts_bbox_head.cls_branches.0.6.bias"][0]) == pytest.approx(-4.595)
    assert float(sd["img_backbone.bn1.running_var"].min()) == 1.0


def test_flop_counter_against_a_hand_count():
    """Each product kind counted as 2 a multiply-add, on hand-made shapes."""
    c = Counter()
    w = {"c.weight": torch.zeros(8, 4, 3, 3), "c.bias": torch.zeros(8),
         "l.weight": torch.zeros(5, 6), "l.bias": torch.zeros(5),
         "d.weight": torch.zeros(4, 4, 3, 3), "d.conv_offset.weight": torch.zeros(27, 4, 3, 3),
         "d.conv_offset.bias": torch.zeros(27),
         "a.in_proj_weight": torch.zeros(24, 8), "a.in_proj_bias": torch.zeros(24),
         "a.out_proj.weight": torch.zeros(8, 8), "a.out_proj.bias": torch.zeros(8)}
    ref = Reference(w, {"embed_dims": 8, "num_heads": 2}, c)
    ref.conv(torch.zeros(2, 4, 10, 12), "c", 1, 1, bias=True)
    assert c.flops["conv"] == 2 * (2 * 8 * 10 * 12) * (4 * 9)
    ref.linear(torch.zeros(7, 6), "l")
    assert c.flops["dense"] == 2 * 7 * 5 * 6
    ref.dcn(torch.zeros(1, 4, 6, 6), "d", 1)
    assert c.flops["dcn"] == 2 * 1 * 4 * 36 * 4 * 9
    assert c.flops["conv"] == 2 * (2 * 8 * 10 * 12) * 36 + 2 * (27 * 36) * (4 * 9)
    dense = c.flops["dense"]
    ref.self_attn(torch.zeros(1, 3, 8), torch.zeros(1, 3, 8), "a")
    assert c.flops["attention"] == 4 * 2 * 3 * 3 * 4  # heads x Lq x Lk x head width
    assert c.flops["dense"] - dense == 4 * 2 * 3 * 8 * 8


@pytest.mark.parametrize("config", sorted(c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]))
def test_config_flops_are_the_counters(config):
    """The configuration file's FLOPs a frame are the counter's over the
    reference at the file's sizes (shapes only: on the meta device)."""
    doc = json.loads((ROOT / "portbench/configs" / f"{config}.json").read_text())
    m = doc["model"]
    meta = torch.device("meta")
    w = {k: torch.empty(s, device=meta) for k, s, _ in checkpoint_specs(m)}
    c = Counter()
    Reference(w, m, c).frame(torch.empty((m["num_cams"], 3, m["img_h"], m["img_w"]), device=meta),
                             None, 0.0, torch.empty(18, device=meta),
                             torch.empty((m["num_cams"], 4, 4), device=meta))
    assert c.total == doc["flops_per_frame"]
