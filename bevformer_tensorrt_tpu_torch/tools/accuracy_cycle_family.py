"""The BEVDet accuracy cycle on generated scenes: train -> fp eval ->
calibrate -> int8 eval -> QAT -> int8 eval (port of the BEVDet part of
`tools/accuracy_cycle_family.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.accuracy_cycle_family [--family bevdet]
        [--frames 8] [--steps 800] [--qat-steps 100] [--seed 0]
        [--out accuracy_families.json] [--workdir DIR] [--device cuda]

The reference publishes int8 accuracy for BEVDet-R50 (NDS 0.372 int8
against 0.377 fp).  Without nuScenes in the repo the cycle renders a set of
`--frames` frames with `tools/make_synthetic_nuscenes.py` (2 cameras of
128x64, the same GT in every frame), overfits BEVDet-micro on it
(`--ranks-pad 8192`), calibrates with `percentile`, and fine-tunes with QAT
at lr 2e-5, the JAX tool's stages, flags and defaults.

Every stage is a subprocess of the port's CLIs (`tools.bevdet.train`,
`tools.bevdet.evaluate`, `tools.bevdet.calibrate`); the generator runs as a
subprocess too.  The record (written to `--out` and printed as the last
line) has the JAX tool's keys, `fp`, `int8_ptq`, `int8_qat`,
`nds_drop_ptq`, `nds_drop_qat`, `steps`, `qat_steps`, `seed` and `wall_s`,
plus `device`: the card's name and power limit as nvidia-smi gives them, or
"cpu".  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from ..runtime.engine import resolve_device
from .accuracy_cycle import PACKAGE, REPO, device_name, last_json, run


def cycle_bevdet(args, wd: Path, dev) -> dict:
    py = sys.executable
    synth = wd / "synth"
    infos = synth / "nuscenes_infos_synthetic.pkl"
    run([py, REPO / "tools/make_synthetic_nuscenes.py", synth, "--frames", args.frames,
         "--seed", args.seed, "--cams", "2", "--width", "128", "--height", "64", "--shared-gt"],
        wd / "00_data.log")

    def tool(name):
        return [py, "-m", f"{PACKAGE}.tools.bevdet.{name}"]

    common = ["--model", "micro", "--infos", infos, "--data-root", synth, "--ranks-pad", "8192",
              *dev]
    ckpt = wd / "fp.pth"
    run([*tool("train"), *common, "--steps", args.steps, "--log-every", "50", "--out", ckpt],
        wd / "01_train.log")
    fp = last_json(run([*tool("evaluate"), *common, "--checkpoint", ckpt], wd / "02_eval_fp.log"))
    scales = wd / "scales.npz"
    run([*tool("calibrate"), *common, "--checkpoint", ckpt, "--length", args.frames,
         "--method", "percentile", "--out", scales], wd / "03_calibrate.log")
    int8 = ["--quant-scales", scales, "--quant", "int8"]
    ptq = last_json(run([*tool("evaluate"), *common, "--checkpoint", ckpt, *int8],
                        wd / "04_eval_int8.log"))
    qat_ckpt = wd / "qat.pth"
    run([*tool("train"), *common, "--steps", args.qat_steps, "--log-every", "25",
         "--checkpoint", ckpt, "--quant-scales", scales, "--lr", "2e-5", "--out", qat_ckpt],
        wd / "05_qat.log")
    qat = last_json(run([*tool("evaluate"), *common, "--checkpoint", qat_ckpt, *int8],
                        wd / "06_eval_qat.log"))
    return {
        "fp": fp, "int8_ptq": ptq, "int8_qat": qat,
        "nds_drop_ptq": round(fp["NDS"] - ptq["NDS"], 4),
        "nds_drop_qat": round(fp["NDS"] - qat["NDS"], 4),
        "reference_rows": "BEVDet R50 int8 NDS 0.372 vs fp 0.377 (README.md:81-84); "
                          "synthetic-overfit analogue at micro",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported yet: the yolox and centernet families (they need the 2D trainer).")
    ap.add_argument("--family", action="append", choices=["bevdet"], default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--qat-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="accuracy_families.json")
    ap.add_argument("--workdir", default=None,
                    help="default: acc_fam under the system's temporary directory")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    root = Path(args.workdir or Path(tempfile.gettempdir()) / "acc_fam")
    dev = ["--device", str(device)]
    out = {}
    t0 = time.time()
    for fam in args.family or ["bevdet"]:
        wd = root / fam
        wd.mkdir(parents=True, exist_ok=True)
        print(f"=== {fam} cycle ===", file=sys.stderr, flush=True)
        out[fam] = cycle_bevdet(args, wd, dev)
        rec = {**out, "steps": args.steps, "qat_steps": args.qat_steps, "seed": args.seed,
               "device": device_name(device), "wall_s": round(time.time() - t0, 1)}
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
