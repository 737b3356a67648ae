"""The port's 2D train CLI on a generated COCO-format set on the CPU
(micro): 3 steps with the augmentation and 3 without, its upstream-layout
`.pth` read back by the evaluator, the calibrator and the exporter, and a
QAT run from the calibrator's scales.  The 2D accuracy cycle is in
tests/test_torch_2d_accuracy_cycle.py."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.runtime.export import load_program
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    centernet_upstream_layout,
    load_centernet_checkpoint,
    load_torch_checkpoint,
    load_yolox_checkpoint,
    yolox_upstream_layout,
)
from bevformer_tensorrt_tpu_torch.tools.det2d import calibrate, evaluate, export, train

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """8 generated images of at most 96 px."""
    root = tmp_path_factory.mktemp("coco_train") / "set"
    repo = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, str(repo / "tools/make_synthetic_coco.py"), str(root),
                    "--images", "8", "--size", "96"], check=True, capture_output=True, timeout=120)
    return root


def _args(model, root):
    return [model, "--ann", str(root / "instances_synthetic.json"), "--img-root",
            str(root / "images"), "--device", "cpu"]


@pytest.mark.parametrize("model", ["yolox_micro", "centernet_micro"])
def test_train_cli_round_trip(model, coco_set, tmp_path):
    """3 augmented steps, then 3 more without augmentation from their
    `.pth` (finite losses, GT in every batch); the `.pth` is upstream
    layout, loads strictly and holds the trained weights, which
    tools/det2d/evaluate.py reads back; tools/det2d/calibrate.py then QAT
    (lr 1e-6 by default) whose `.pth` evaluates under int8."""
    yolox = model.startswith("yolox")
    load = load_yolox_checkpoint if yolox else load_centernet_checkpoint
    layout = yolox_upstream_layout if yolox else centernet_upstream_layout
    aug_out, out = str(tmp_path / "aug.pth"), str(tmp_path / "fp.pth")
    aug = train.main(_args(model, coco_set) + ["--steps", "3", "--batch", "2", "--log-every", "1",
                                               "--out", aug_out])
    res = train.main(_args(model, coco_set) + ["--steps", "3", "--batch", "2", "--no-augment",
                                               "--checkpoint", aug_out, "--out", out])
    for r in (aug, res):
        assert len(r.metrics) == 3 and all(np.isfinite(m["loss"]) for m in r.metrics)
        assert all(m["num_pos"] > 0 for m in r.metrics)
        assert r.optimizer.peak == 1e-4 and r.optimizer.count == 3
    assert res.dataset.to_rgb is (not yolox)  # CenterNet trains on the evaluator's norm
    sd = load(res.cfg, load_torch_checkpoint(out))
    assert set(load_torch_checkpoint(out)) == set(layout(res.cfg, sd))
    for k, v in res.model.state_dict().items():
        assert torch.equal(sd[k], v.cpu()), k
    start = load(res.cfg, load_torch_checkpoint(aug_out))
    assert any(not torch.equal(start[k], sd[k]) for k in sd)
    ev = evaluate.main(_args(model, coco_set) + ["--checkpoint", out, "--batch", "4"])
    assert all(np.isfinite(v) for v in ev.metrics.values())
    for k, v in sd.items():
        assert torch.equal(ev.engine.model.state_dict()[k].cpu(), v), k
    scales = str(tmp_path / "scales.npz")
    calibrate.main(_args(model, coco_set) + ["--checkpoint", out, "--length", "4", "--batch", "4",
                                             "--method", "max", "--out", scales])
    qat_out = str(tmp_path / "qat.pth")
    qat = train.main(_args(model, coco_set) + ["--steps", "2", "--batch", "2", "--no-augment",
                                               "--checkpoint", out, "--quant-scales", scales,
                                               "--out", qat_out])
    assert qat.cfg.quant is True and qat.optimizer.peak == 1e-6
    assert all(np.isfinite(m["loss"]) for m in qat.metrics)
    moved = load(res.cfg, load_torch_checkpoint(qat_out))
    assert any(not torch.equal(moved[k], sd[k]) for k in sd)
    ev8 = evaluate.main(_args(model, coco_set) + ["--checkpoint", qat_out, "--quant-scales",
                                                  scales, "--batch", "4"])
    assert ev8.engine.cfg.quant == "int8" and all(np.isfinite(v) for v in ev8.metrics.values())
    if yolox:  # the exporter reads the .pth too: the program holds the trained weights
        prog = tmp_path / "prog"
        export.main(_args(model, coco_set)[:1] + ["--batch", "2", "--checkpoint", out,
                                                  "--out", str(prog), "--device", "cpu"])
        images = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 255, (2, 3, 64, 64)).astype(np.float32))
        want = ev.engine.heads(images)
        got = load_program(prog, "cpu")(images)
        for g, w in zip(got, want):
            for k in w:
                assert torch.equal(g[k], w[k]), k
