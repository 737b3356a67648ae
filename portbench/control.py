"""The readings that the limits of `portbench/limits/<workload>.json` are set
from: the program as the configuration states it over a dozen seeds or more
(the lower readings), and the control, the program's own int8 path
(`quant="int8"`, the deployment tier below bfloat16, calibrated by `max`
over the warm-up frames), over three seeds or more (the upper readings).

    python3 -m portbench.control --workload <name> --seconds <s> --control-seconds <s>
        --first-seed <n> [--sound 12] [--control 3]

Each seed is one run of the cell (`run.run_cell`, without the look for a
limit: every number is printed), all in this process so that the imports
and the kernels' load are paid once.  One JSON line a run on standard
output: the seed, "sound" or "control", `correct` under the current limits,
and the numbers.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import run


def readings(cell, seeds, seconds: float, control: bool):
    for seed in seeds:
        over = {"quant": "int8"} if control else {}
        res = run.run_cell(cell, seed, seconds, False, torch.device("cuda"), overrides=over,
                           calibrate="max" if control else None)
        rec = {"seed": seed, "kind": "control" if control else "sound",
               "correct": res["correct"], "frames_checked": res["frames_checked"],
               "numbers": {k: v["value"] for k, v in res["checks"].items()},
               "fps": res["metrics"]["fps"]["value"], "phases_s": res["phases_s"]}
        print(json.dumps(rec), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float, required=True,
                    help="the control's window: long enough for its slower frames to reach "
                         "the checked ones")
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    seeds = range(args.first_seed, args.first_seed + args.sound + args.control)
    sound = list(readings(cell, seeds[:args.sound], args.seconds, False))
    ctrl = list(readings(cell, seeds[args.sound:], args.control_seconds, True))
    summary = {k: {"lower": max(r["numbers"][k] for r in sound),
                   "upper": min(r["numbers"][k] for r in ctrl) if ctrl else None}
               for k in sound[0]["numbers"]}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
