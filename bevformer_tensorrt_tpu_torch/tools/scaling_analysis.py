"""Per-collective communication of the sharded train step and a ring-model
projection of its cost (port of `tools/scaling_analysis.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.scaling_analysis [--dp 2 --tp 4]
        [--model micro] [--device cpu|cuda] [--tp-bw B/s] [--dp-bw B/s] [--out FILE]

The JAX tool walks the compiled HLO for the collectives GSPMD inserted.  The
port calls its collectives itself, and `parallel/comm.py` counts each by
kind and mesh axis with its payload bytes: this tool runs dp x tp ranks (one
process each, as `scaling_bench`), takes one warm-up step, resets the
counters and reads them over one `train_step`, on rank 0.  The counts and
bytes are exact.

The projection keeps the JAX tool's ring model: an all-reduce of b bytes in
a group of g costs 2 b (g - 1) / g / bw, an all-gather b (g - 1) / g / bw
(b the gathered part), a point-to-point hop b / bw; tp traffic rides the
`--tp-bw` link, dp traffic `--dp-bw`.  The bandwidths are arguments, printed
as assumptions: the defaults are the H100 SXM's published NVLink rate (450
GB/s a direction) and one 400 Gb/s network port a card, not measurements,
and the JAX tool's TPU figures do not carry over.  The compute term is this
run's measured step time on rank 0's device (`t_step_s`), and the
efficiencies use it: they mean something only where the step ran on the
card the bandwidths describe.  A base-tier line gives base's gradient bytes
(float32 parameters, one dp all-reduce a step) at `--dp-bw`.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from .scaling_bench import _sync, join, spawn, train_setup

TP_BW = 450e9  # bytes/s a direction: H100 SXM NVLink 4 (published), an assumption
DP_BW = 50e9   # bytes/s: one 400 Gb/s network port a card (published), an assumption


def ring_time(kind: str, bytes_: float, g: int, bw: float) -> float:
    """The ring-collective cost of the JAX tool (scaling-book collectives)."""
    if g <= 1:
        return 0.0
    if kind.startswith("all_reduce"):
        return 2 * bytes_ * (g - 1) / g / bw
    if kind == "send_recv":
        return bytes_ / bw
    return bytes_ * (g - 1) / g / bw  # all-gather (bytes: this rank's part), broadcast


def rank_main(args) -> None:
    import torch.distributed as dist

    from ..parallel import comm
    from ..train import train_step

    dev, mesh, _ = join(args.device, args.dp, args.tp)
    net, opt, batch = train_setup(args.model, dev, mesh)
    train_step(net, opt, batch, mesh)
    _sync(dev)
    comm.reset_counts()
    t0 = time.perf_counter()
    train_step(net, opt, batch, mesh)
    _sync(dev)
    t_step = time.perf_counter() - t0
    if mesh.rank == 0:
        Path(args.result).write_text(json.dumps({
            "mesh": mesh.describe(), "device": str(dev), "backend": mesh.backend,
            "t_step_s": t_step, "collectives": comm.counts(),
            "group": {a: mesh.axis_size(a) for a in mesh.axis_names}}))
    dist.barrier()
    dist.destroy_process_group()


def base_param_bytes() -> int:
    """Bytes of BEVFormer-base's float32 parameters (built on the meta device)."""
    from ..configs.bevformer import bevformer_base
    from ..models.detectors.bevformer import BEVFormer

    with torch.device("meta"):
        model = BEVFormer(bevformer_base())
    return sum(p.numel() * 4 for p in model.parameters())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--model", default="micro", choices=("micro", "tiny", "small", "base"))
    ap.add_argument("--device", default="cpu", choices=("cuda", "cpu"))
    ap.add_argument("--tp-bw", type=float, default=TP_BW, help="bytes/s of the tp link")
    ap.add_argument("--dp-bw", type=float, default=DP_BW, help="bytes/s of the dp link")
    ap.add_argument("--out", default=None)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)  # a rank's result file
    args = ap.parse_args(argv)
    if args.result:
        return rank_main(args)
    n = args.dp * args.tp
    with tempfile.TemporaryDirectory() as tmp:
        res = Path(tmp) / "rank0.json"
        spawn("bevformer_tensorrt_tpu_torch.tools.scaling_analysis", n,
              ["--model", args.model, "--device", args.device, "--dp", str(args.dp),
               "--tp", str(args.tp), "--result", str(res)])
        run = json.loads(res.read_text())
    bw = {"tp": args.tp_bw, "dp": args.dp_bw, "world": args.dp_bw}
    t_axis = {"tp": 0.0, "dp": 0.0}
    for c in run["collectives"]:
        g = run["group"].get(c["axis"], n)
        c["model_s"] = ring_time(c["kind"], c["bytes"], g, bw.get(c["axis"], args.dp_bw))
        t_axis["tp" if c["axis"] == "tp" else "dp"] += c["model_s"]
    t = run["t_step_s"]
    t_dp_b = ring_time("all_reduce", base_param_bytes(), max(args.dp, 2), args.dp_bw)
    rec = {
        "mesh": run["mesh"], "model": f"{args.model} train step ({run['backend']} on "
                                      f"{run['device']})",
        "collectives": run["collectives"],
        "total_comm_bytes": int(sum(c["bytes"] for c in run["collectives"])),
        "ring_model": {
            "assumptions": {"tp_bw_Bps": args.tp_bw, "dp_bw_Bps": args.dp_bw,
                            "note": "byte counts exact (parallel/comm.py counters); times are a "
                                    "ring-model projection at these assumed bandwidths, with "
                                    "the step time measured in this run"},
            "t_step_s": t, "t_tp_s": t_axis["tp"], "t_dp_s": t_axis["dp"],
            "efficiency_no_overlap": t / (t + t_axis["tp"] + t_axis["dp"]),
            "efficiency_with_overlap": t / (t + t_axis["tp"] + 0.2 * t_axis["dp"]),
        },
        "base_tier": {"param_bytes": base_param_bytes(), "t_dp_s": t_dp_b,
                      "note": "one dp all-reduce of base's float32 gradients a step at dp_bw"},
    }
    for c in run["collectives"]:
        print(f"{c['kind']:16s} {c['axis']:6s} x{c['count']:4d} {c['bytes'] / 1e6:10.3f} MB",
              file=sys.stderr)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "collectives"}))
    return rec


if __name__ == "__main__":
    main()
