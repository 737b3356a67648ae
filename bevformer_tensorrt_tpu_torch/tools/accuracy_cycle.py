"""The accuracy cycle on generated scenes: train -> fp eval -> calibrate ->
int8 eval -> QAT -> int8 eval (port of `tools/accuracy_cycle.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.accuracy_cycle [--model tiny]
        [--frames 16] [--steps 200] [--qat-steps 30] [--lr 2e-4] [--qat-lr 1e-5]
        [--method percentile] [--exclude PATTERN ...] [--seed 0] [--shared-gt]
        [--out accuracy_cycle.json] [--workdir DIR] [--device cuda]

The reference's acceptance test is NDS on nuScenes val with at most 0.003
lost under int8.  Without nuScenes in the repo, the cycle renders a set with
`tools/make_synthetic_nuscenes.py` (micro: 2 cameras of 160x96; tiny and
small: 6 of 800x480), overfits the model on it, and sets the int8 evaluations
beside the floating-point model's own NDS.

Every stage is a subprocess of the port's CLIs (`tools.train`,
`tools.evaluate`, `tools.calibrate`); the generator runs as a subprocess too.
The stages' processes start together and import while the earlier stages
run (`Stages`); each still runs only after the one before it has ended.
A stage that fails ends the cycle with its log's tail.  The record (written
to `--out` and printed as the last line) has the JAX tool's keys, `fp`
(bfloat16), `fp32`, `int8_ptq`, `int8_qat`, `nds_drop_ptq`, `nds_drop_qat`,
`nds_delta_bf16_vs_fp32` and `wall_s`, plus `device`: the card's name and
power limit as nvidia-smi gives them, or "cpu".  Runs on CUDA unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..runtime.engine import resolve_device

REPO = Path(__file__).resolve().parents[2]
PACKAGE = "bevformer_tensorrt_tpu_torch"


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def _finish(cmd, log: Path, returncode: int) -> str:
    text = Path(log).read_text()
    if returncode != 0:
        raise SystemExit(f"stage failed ({' '.join(map(str, cmd[1:4]))}), exit {returncode}:\n"
                         f"{text[-3000:]}")
    return text


def run(cmd, log: Path) -> str:
    """Run one stage with its output in `log`; raise with the log's tail if
    it fails."""
    print(f"+ {' '.join(map(str, cmd))}", file=sys.stderr, flush=True)
    with open(log, "w") as f:
        r = subprocess.run(list(map(str, cmd)), stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
                           env=_env())
    return _finish(cmd, log, r.returncode)


# a stage process started ahead of its turn: it imports its CLI module (and
# with it torch and the port), then waits on stdin for its arguments and log,
# and runs the module as `python -m` would
_WAITING = (
    "import importlib, json, os, runpy, sys\n"
    "importlib.import_module(sys.argv[1])\n"
    "job = sys.stdin.readline()\n"
    "if not job:\n"
    "    sys.exit(0)\n"
    "job = json.loads(job)\n"
    "fd = os.open(job['log'], os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)\n"
    "os.dup2(fd, 1)\n"
    "os.dup2(fd, 2)\n"
    "sys.argv = [sys.argv[1]] + job['argv']\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


class Stages:
    """The cycle's CLI stages as processes started ahead of their turn, each
    importing its module while the stages before it run, and each released
    in turn by `run`: every stage is still a process of its own and runs
    only after the one before it has ended, but the interpreter's start and
    the imports (most of a micro stage's seconds) overlap the earlier
    stages.  `modules` lists one entry per stage, in the order `run` takes
    them; at most `ahead` of them wait at a time (all, by default).  A
    command that is not `python -m <the next listed module>` runs as a plain
    subprocess.  Use as a context manager: the processes left waiting are
    ended at its exit."""

    def __init__(self, modules, ahead: int = 0):
        self.todo = list(modules)
        self.ahead = ahead or len(self.todo)
        self.waiting = []
        self._fill()

    def _fill(self):
        while self.todo and len(self.waiting) < self.ahead:
            m = self.todo.pop(0)
            self.waiting.append((m, subprocess.Popen(
                [sys.executable, "-c", _WAITING, m], stdin=subprocess.PIPE, cwd=REPO,
                env=_env(), text=True)))

    def run(self, cmd, log: Path) -> str:
        cmd = [str(c) for c in cmd]
        if not (self.waiting and len(cmd) > 2 and cmd[1] == "-m"
                and self.waiting[0][0] == cmd[2]):
            return run(cmd, log)
        print(f"+ {' '.join(cmd)}", file=sys.stderr, flush=True)
        _, p = self.waiting.pop(0)
        self._fill()
        p.stdin.write(json.dumps({"argv": cmd[3:], "log": str(log)}) + "\n")
        p.stdin.close()
        return _finish(cmd, log, p.wait())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for _, p in self.waiting:
            p.stdin.close()
            p.wait()
        self.waiting, self.todo = [], []


def last_json(text: str) -> dict:
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise SystemExit("no JSON line found in the stage's output")


def device_name(device) -> str:
    """The card's name and power limit (nvidia-smi), or the device's type."""
    if device.type != "cuda":
        return device.type
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=["micro", "tiny", "small"])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--qat-steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--qat-lr", type=float, default=1e-5,
                    help="QAT fine-tune lr (reference: 1e-6 for a full epoch; higher here to "
                         "move in a short run)")
    ap.add_argument("--method", default="percentile",
                    help="calibration method (percentile 99.99 is the reference's QDQ default)")
    ap.add_argument("--exclude", action="append", default=None,
                    help="site pattern kept in floating point (repeatable), passed to the "
                         "calibration and kept in the scales' policy")
    ap.add_argument("--out", default="accuracy_cycle.json")
    ap.add_argument("--workdir", default=None,
                    help="default: acc_cycle under the system's temporary directory")
    ap.add_argument("--seed", type=int, default=0, help="the generated scenes' seed")
    ap.add_argument("--shared-gt", action="store_true",
                    help="the same GT in every frame: meaningful AP in a short overfit run")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    wd = Path(args.workdir or Path(tempfile.gettempdir()) / "acc_cycle")
    wd.mkdir(parents=True, exist_ok=True)
    synth = wd / "synth"
    infos = synth / "nuscenes_infos_synthetic.pkl"
    t0 = time.time()
    dev = ["--device", str(device)]

    if args.model == "micro":
        shape = ["--cams", "2", "--width", "160", "--height", "96"]
    else:
        shape = ["--cams", "6", "--width", "800", "--height", "480"]
    extra = ["--shared-gt"] if args.shared_gt else []
    with Stages([f"{PACKAGE}.tools.{m}" for m in ("train", "evaluate", "evaluate", "calibrate",
                                                  "evaluate", "train", "evaluate")]) as st:
        results = stages(args, st.run, wd, synth, infos, shape + extra, dev)
    rec = _record(args, device, *results, t0)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


def stages(args, run, wd: Path, synth: Path, infos: Path, gen_args, dev):
    """The cycle's stages in turn through `run`: (fp, fp32, ptq, qat) metrics."""
    py = sys.executable
    run([py, REPO / "tools/make_synthetic_nuscenes.py", synth, "--frames", args.frames,
         "--seed", args.seed, *gen_args], wd / "00_data.log")

    def tool(name):
        return [py, "-m", f"{PACKAGE}.tools.{name}", args.model, "--infos", infos,
                "--data-root", synth]

    ckpt = wd / "fp.pth"
    run([*tool("train"), "--steps", args.steps, "--lr", args.lr, "--no-augment",
         "--log-every", "20", "--save-every", "0", "--out", ckpt, *dev], wd / "01_train.log")

    # bfloat16 is the deploy dtype (the int8 evaluations run their
    # floating-point sites in it too); float32 records the dtype's own delta
    fp = last_json(run([*tool("evaluate"), "--dtype", "bfloat16", "--checkpoint", ckpt, *dev],
                       wd / "02_eval_fp.log"))
    fp32 = last_json(run([*tool("evaluate"), "--dtype", "float32", "--checkpoint", ckpt, *dev],
                         wd / "02_eval_fp32.log"))

    scales = wd / "scales.npz"
    cal = [*tool("calibrate"), "--checkpoint", ckpt, "--length", args.frames, "--method",
           args.method, "--out", scales, *dev]
    for p in args.exclude or ():
        cal += ["--exclude", p]
    run(cal, wd / "03_calibrate.log")

    int8 = ["--dtype", "bfloat16", "--quant-scales", scales, "--quant", "int8", *dev]
    ptq = last_json(run([*tool("evaluate"), "--checkpoint", ckpt, *int8],
                        wd / "04_eval_int8.log"))

    # QAT: the calibrated scales fixed, a low-lr fine-tune with the QDQ sites
    # live (the reference's quant_aware_train.sh recipe, scaled to the run)
    qat_ckpt = wd / "qat.pth"
    run([*tool("train"), "--steps", args.qat_steps, "--no-augment", "--log-every", "10",
         "--lr", args.qat_lr, "--checkpoint", ckpt, "--quant-scales", scales, "--save-every",
         "0", "--out", qat_ckpt, *dev], wd / "05_qat.log")
    qat = last_json(run([*tool("evaluate"), "--checkpoint", qat_ckpt, *int8],
                        wd / "06_eval_qat_int8.log"))
    return fp, fp32, ptq, qat


def _record(args, device, fp, fp32, ptq, qat, t0) -> dict:
    return {
        "model": args.model,
        "seed": args.seed,
        "frames": args.frames,
        "train_steps": args.steps,
        "qat_steps": args.qat_steps,
        "method": args.method,
        "exclude": list(args.exclude or ()),
        "device": device_name(device),
        "fp": fp,
        "fp32": fp32,
        "nds_delta_bf16_vs_fp32": round(fp32["NDS"] - fp["NDS"], 4),
        "int8_ptq": ptq,
        "int8_qat": qat,
        "nds_drop_ptq": round(fp["NDS"] - ptq["NDS"], 4),
        "nds_drop_qat": round(fp["NDS"] - qat["NDS"], 4),
        "reference_envelope": "int8 drop <= 0.003 NDS on real nuScenes; "
                              "a synthetic-overfit analogue",
        "wall_s": round(time.time() - t0, 1),
    }


if __name__ == "__main__":
    main()
