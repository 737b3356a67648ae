"""The accuracy cycles of the BEVDet and 2D families on generated data:
train -> fp eval -> calibrate -> int8 eval -> QAT -> int8 eval (port of
`tools/accuracy_cycle_family.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.accuracy_cycle_family
        [--family bevdet|yolox|centernet ...] [--frames 8] [--images 48] [--steps 800]
        [--qat-steps 100] [--seed 0] [--out accuracy_families.json]
        [--workdir DIR] [--device cuda]

The reference publishes int8 accuracy for BEVDet-R50 (NDS 0.372 int8
against 0.377 fp), YOLOX-x (mAP 0.494 against 0.506) and CenterNet-R18
(0.261 against 0.299).  Without nuScenes or COCO in the repo each cycle runs
on generated data, with the JAX tool's stages, flags and defaults:
  * bevdet: `--frames` frames of `tools/make_synthetic_nuscenes.py` (2
    cameras of 128x64, the same GT in every frame), BEVDet-micro
    (`--ranks-pad 8192`);
  * yolox, centernet: `--images` images of `tools/make_synthetic_coco.py` at 96 px,
    `{family}_micro` at batch 8 without augmentation;
then `percentile` calibration (over all the images for the 2D families) and
QAT at lr 2e-5.  Without `--family` the cycle runs bevdet.

Every stage is a subprocess of the port's CLIs (`tools.bevdet.*`,
`tools.det2d.*`); the generators run as subprocesses too.  The record
(written to `--out` and printed as the last line) has the JAX tool's keys,
per family `fp`, `int8_ptq`, `int8_qat` and `nds_drop_ptq` / `nds_drop_qat`
(BEVDet) or `map_drop_ptq` / `map_drop_qat` (2D), then `steps`,
`qat_steps`, `seed` and `wall_s`, plus `device`: the card's name and power
limit as nvidia-smi gives them, or "cpu".  Runs on CUDA unless `--device
cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from ..runtime.engine import resolve_device
from .accuracy_cycle import PACKAGE, REPO, Stages, device_name, last_json


def cycle_bevdet(args, wd: Path, dev, run) -> dict:
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


def cycle_2d(which: str, args, wd: Path, dev, run) -> dict:
    py = sys.executable
    synth = wd / "synth"
    run([py, REPO / "tools/make_synthetic_coco.py", synth, "--images", args.images, "--size", "96",
         "--seed", args.seed], wd / "00_data.log")

    def tool(name):
        return [py, "-m", f"{PACKAGE}.tools.det2d.{name}"]

    model = f"{which}_micro"
    common = [model, "--ann", synth / "instances_synthetic.json", "--img-root", synth / "images",
              *dev]
    train = ["--batch", "8", "--no-augment"]
    ckpt = wd / "fp.pth"
    run([*tool("train"), *common, *train, "--steps", args.steps, "--log-every", "50",
         "--out", ckpt], wd / "01_train.log")
    fp = last_json(run([*tool("evaluate"), *common, "--checkpoint", ckpt], wd / "02_eval_fp.log"))
    scales = wd / "scales.npz"
    run([*tool("calibrate"), *common, "--checkpoint", ckpt, "--length", args.images,
         "--method", "percentile", "--out", scales], wd / "03_calibrate.log")
    int8 = ["--quant-scales", scales, "--quant", "int8"]
    ptq = last_json(run([*tool("evaluate"), *common, "--checkpoint", ckpt, *int8],
                        wd / "04_eval_int8.log"))
    qat_ckpt = wd / "qat.pth"
    run([*tool("train"), *common, *train, "--steps", args.qat_steps, "--log-every", "25",
         "--checkpoint", ckpt, "--quant-scales", scales, "--lr", "2e-5", "--out", qat_ckpt],
        wd / "05_qat.log")
    qat = last_json(run([*tool("evaluate"), *common, "--checkpoint", qat_ckpt, *int8],
                        wd / "06_eval_qat.log"))
    return {
        "fp": fp, "int8_ptq": ptq, "int8_qat": qat,
        "map_drop_ptq": round(fp["mAP"] - ptq["mAP"], 4),
        "map_drop_qat": round(fp["mAP"] - qat["mAP"], 4),
        "reference_rows": "YOLOX-x int8 mAP 0.494 vs fp 0.506; CenterNet int8 0.261 vs fp "
                          "0.299 (README.md:92-108); synthetic micro analogue",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", action="append", choices=["bevdet", "yolox", "centernet"],
                    default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--images", type=int, default=48,
                    help="the 2D families' generated images, all of them calibrated on")
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
        pkg = f"{PACKAGE}.tools.{'bevdet' if fam == 'bevdet' else 'det2d'}"
        with Stages([f"{pkg}.{m}" for m in ("train", "evaluate", "calibrate", "evaluate", "train",
                                            "evaluate")]) as st:
            out[fam] = (cycle_bevdet(args, wd, dev, st.run) if fam == "bevdet"
                        else cycle_2d(fam, args, wd, dev, st.run))
        rec = {**out, "steps": args.steps, "qat_steps": args.qat_steps, "seed": args.seed,
               "device": device_name(device), "wall_s": round(time.time() - t0, 1)}
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
