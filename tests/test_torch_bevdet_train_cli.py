"""The port's BEVDet train CLI on a generated set on the CPU (micro): its
`.pth` read back by the evaluator and the calibrator, a QAT run from it, and
the BEVDet accuracy cycle at its smallest.  A file of its own: the cycle
runs seven subprocesses."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    bevdet_upstream_layout,
    load_bevdet_checkpoint,
    load_torch_checkpoint,
)
from bevformer_tensorrt_tpu_torch.tools import accuracy_cycle_family
from bevformer_tensorrt_tpu_torch.tools.bevdet import calibrate, evaluate, train

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bevdet_set(tmp_path_factory):
    """The accuracy cycle's set at its smallest: 4 frames, 2 cameras of
    128x64, the same GT in every frame."""
    root = tmp_path_factory.mktemp("bevdet_train") / "set"
    repo = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, str(repo / "tools/make_synthetic_nuscenes.py"), str(root),
                    "--frames", "4", "--cams", "2", "--width", "128", "--height", "64",
                    "--shared-gt"], check=True, capture_output=True, timeout=120)
    return root


def _args(root):
    return ["--model", "micro", "--infos", str(root / "nuscenes_infos_synthetic.pkl"),
            "--data-root", str(root), "--ranks-pad", "8192", "--device", "cpu"]


def test_train_cli_round_trip(bevdet_set, tmp_path):
    """tools/bevdet/train.py for 3 steps: finite losses, an upstream-layout
    `.pth` that loads strictly and holds the trained weights, read back by
    tools/bevdet/evaluate.py and tools/bevdet/calibrate.py; then QAT from it
    (lr 1e-6 by default) whose `.pth` evaluates under int8."""
    out = str(tmp_path / "fp.pth")
    res = train.main(_args(bevdet_set) + ["--steps", "3", "--log-every", "1", "--out", out])
    assert len(res.metrics) == 3 and all(np.isfinite(m["loss"]) for m in res.metrics)
    assert all(m["num_pos"] > 0 for m in res.metrics)
    sd = load_bevdet_checkpoint(res.cfg, load_torch_checkpoint(out))
    for k, v in res.model.state_dict().items():
        if k in sd:
            assert torch.equal(sd[k], v.cpu()), k
    assert set(load_torch_checkpoint(out)) == set(bevdet_upstream_layout(res.cfg, sd))
    ev = evaluate.main(_args(bevdet_set) + ["--checkpoint", out])
    assert all(np.isfinite(v) for v in ev.metrics.values())
    for k, v in sd.items():
        assert torch.equal(ev.engine.model.state_dict()[k].cpu(), v), k
    scales = str(tmp_path / "scales.npz")
    calibrate.main(_args(bevdet_set) + ["--checkpoint", out, "--length", "2", "--method", "max",
                                        "--out", scales])
    qat_out = str(tmp_path / "qat.pth")
    qat = train.main(_args(bevdet_set) + ["--steps", "2", "--checkpoint", out, "--quant-scales",
                                          scales, "--out", qat_out])
    assert qat.cfg.quant is True and qat.optimizer.peak == 1e-6
    moved = load_bevdet_checkpoint(res.cfg, load_torch_checkpoint(qat_out))
    assert any(not torch.equal(moved[k], sd[k]) for k in sd)
    ev8 = evaluate.main(_args(bevdet_set) + ["--checkpoint", qat_out, "--quant-scales", scales,
                                             "--quant", "int8"])
    assert ev8.engine.cfg.quant == "int8" and all(np.isfinite(v) for v in ev8.metrics.values())


def test_accuracy_cycle_family_runs_every_stage(tmp_path):
    """The BEVDet cycle at its smallest on the CPU: every stage a
    subprocess, the JAX record's keys plus `device`."""
    out = tmp_path / "fam.json"
    rec = accuracy_cycle_family.main(["--frames", "2", "--steps", "2", "--qat-steps", "1",
                                      "--device", "cpu", "--workdir", str(tmp_path / "w"),
                                      "--out", str(out)])
    assert json.loads(out.read_text()) == rec and rec["device"] == "cpu"
    fam = rec["bevdet"]
    for k in ("fp", "int8_ptq", "int8_qat", "nds_drop_ptq", "nds_drop_qat"):
        assert k in fam, k
    assert fam["nds_drop_ptq"] == round(fam["fp"]["NDS"] - fam["int8_ptq"]["NDS"], 4)
    logs = sorted(p.name for p in (tmp_path / "w" / "bevdet").glob("*.log"))
    assert logs == ["00_data.log", "01_train.log", "02_eval_fp.log", "03_calibrate.log",
                    "04_eval_int8.log", "05_qat.log", "06_eval_qat.log"]
