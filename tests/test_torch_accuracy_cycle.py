"""The port's accuracy cycle (train -> fp eval -> calibrate -> int8 eval ->
QAT -> int8 eval, every stage a subprocess of the port's CLIs) end to end on
the CPU at its smallest: micro, 2 generated frames, 2 training steps and 1
QAT step."""
import json

from bevformer_tensorrt_tpu_torch.tools import accuracy_cycle

# the JAX tool's record (tools/accuracy_cycle.py), and the card's name
KEYS = ("fp", "fp32", "int8_ptq", "int8_qat", "nds_drop_ptq", "nds_drop_qat",
        "nds_delta_bf16_vs_fp32", "wall_s", "device")


def test_cycle_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the stage processes run beside other tests
    out = tmp_path / "cycle.json"
    rec = accuracy_cycle.main(["--model", "micro", "--frames", "2", "--steps", "2",
                               "--qat-steps", "1", "--device", "cpu", "--workdir",
                               str(tmp_path / "work"), "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert all(k in rec for k in KEYS) and rec["device"] == "cpu"
    for k in ("fp", "fp32", "int8_ptq", "int8_qat"):
        assert 0 <= rec[k]["NDS"] <= 1 and "mAP" in rec[k], k
    assert rec["nds_drop_ptq"] == round(rec["fp"]["NDS"] - rec["int8_ptq"]["NDS"], 4)
    assert rec["nds_drop_qat"] == round(rec["fp"]["NDS"] - rec["int8_qat"]["NDS"], 4)
    logs = sorted(p.name for p in (tmp_path / "work").glob("*.log"))
    assert logs == ["00_data.log", "01_train.log", "02_eval_fp.log", "02_eval_fp32.log",
                    "03_calibrate.log", "04_eval_int8.log", "05_qat.log", "06_eval_qat_int8.log"]
    assert "QAT: " in (tmp_path / "work" / "05_qat.log").read_text()
