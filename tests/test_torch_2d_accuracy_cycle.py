"""The port's 2D accuracy cycle (`tools/accuracy_cycle_family.py --family
yolox`) at its smallest on the CPU.  A file of its own: the cycle runs seven
subprocesses."""
import json

import torch

from bevformer_tensorrt_tpu_torch.tools import accuracy_cycle_family

torch.set_num_threads(2)


def test_accuracy_cycle_2d_runs_every_stage(tmp_path, monkeypatch):
    """The YOLOX cycle at its smallest on the CPU (16 images, 2 + 1 steps):
    every stage a subprocess, the JAX record's keys plus `device`."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the stage processes run beside other tests
    out = tmp_path / "fam.json"
    rec = accuracy_cycle_family.main(["--family", "yolox", "--images", "16", "--steps", "2",
                                      "--qat-steps", "1", "--device", "cpu", "--workdir",
                                      str(tmp_path / "w"), "--out", str(out)])
    assert json.loads(out.read_text()) == rec and rec["device"] == "cpu"
    assert (rec["steps"], rec["qat_steps"], rec["seed"]) == (2, 1, 0)
    fam = rec["yolox"]
    for k in ("fp", "int8_ptq", "int8_qat", "map_drop_ptq", "map_drop_qat"):
        assert k in fam, k
    assert fam["map_drop_ptq"] == round(fam["fp"]["mAP"] - fam["int8_ptq"]["mAP"], 4)
    assert fam["map_drop_qat"] == round(fam["fp"]["mAP"] - fam["int8_qat"]["mAP"], 4)
    logs = sorted(p.name for p in (tmp_path / "w" / "yolox").glob("*.log"))
    assert logs == ["00_data.log", "01_train.log", "02_eval_fp.log", "03_calibrate.log",
                    "04_eval_int8.log", "05_qat.log", "06_eval_qat.log"]
    assert ": 16 images" in (tmp_path / "w" / "yolox" / "00_data.log").read_text()
