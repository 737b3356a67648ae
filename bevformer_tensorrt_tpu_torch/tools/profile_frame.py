"""Where a BEVFormer frame's time goes on the card.

    python -m bevformer_tensorrt_tpu_torch.tools.profile_frame [--model tiny]
        [--dtype float32] [--frames 5] [--quant none] [--exclude PATTERN ...]
        [--out FILE]

Runs BEVFormer tiny, small or base with seeded weights on synthetic frames of one scene through
`BEVFormerEngine`: first the host-clock frame latency (each frame ends in a
synchronise), then a `torch.profiler` window over the same number of
frames.  Prints the device time per frame by kernel family and the top
kernels, and the device busy share: the union of the kernels' intervals
over the profiled window's wall time.  TF32 is off, as in chip_smoke.py.
With `--quant qdq` or `--quant int8` the model is calibrated first (`max`,
two frames); a DCN backbone under int8 needs
`--exclude self_attn/msda_tables dcn_tables`.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import bevformer as configs
from .. import ops
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import synthetic_frames
from .path_diff import QUANT, quant_overrides

FAMILIES = (  # first match wins
    ("int8 gemm kernel", r"int8_gemm_kernel"),
    ("msda int8 kernel", r"msda_kernel<signed char"),
    ("flash int8 kernel", r"flash_int8_kernel"),
    ("msda kernel", r"msda_kernel"),
    ("flash kernel", r"flash_kernel"),
    ("dcn kernel", r"dcn_im2col_kernel"),
    ("memcpy", r"[Mm]emcpy|[Mm]emset"),
    # cuDNN's direct, implicit-GEMM and FFT convolutions; complex (cf32,
    # float2) kernels come only from the FFT convolutions in this model
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|cudnn|nchw|nhwc|cf32|float2"),
    ("matmul", r"gemm|nvjet|cutlass|splitK|Kernel2"),
    ("sort / index", r"sort|radix|scatter|gather|index|Indexing|topk"),
    ("grid_sample", r"grid_sampler"),
    ("reduction / norm", r"reduce|norm|softmax|Norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|CatArray|fill"),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def busy_ms(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=("tiny", "small", "base"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--quant", default="none", choices=tuple(QUANT))
    ap.add_argument("--exclude", nargs="*", default=None,
                    help="quant policy patterns; default: the config's")
    ap.add_argument("--out", help="also write the breakdown as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cfg = getattr(configs, f"bevformer_{args.model}")(
        dtype=args.dtype, **quant_overrides(args.quant, args.exclude))
    engine = BEVFormerEngine(cfg, seed=0)
    frames = synthetic_frames(cfg, np.random.default_rng(0), ["scene"] * (2 * args.frames + 2))
    if cfg.quant:
        engine.calibrate(frames[:2], method="max")
    for f in frames[:2]:  # warm-up
        engine.infer_frame(**f)
    torch.cuda.synchronize()

    lat = []
    for f in frames[2:2 + args.frames]:
        t0 = time.perf_counter()
        engine.infer_frame(**f)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)

    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[2 + args.frames:]:
            engine.infer_frame(**f)
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    n = args.frames
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_frame: the profiler recorded no device activity")
    by_name, by_family, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        dur = e.time_range.elapsed_us() / 1e3
        by_name[e.name] += dur / n
        by_family[family(e.name)] += dur / n
        count[e.name] += 1
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    device_ms = sum(by_family.values())
    res = dict(
        card=card, model=args.model, dtype=args.dtype, quant=args.quant, frames=n,
        latency_ms_median=float(np.median(lat)), latency_ms=lat,
        profiled_wall_ms_per_frame=window_ms / n, device_ms_per_frame=device_ms,
        device_busy_share=busy / window_ms, kernels_per_frame=len(kernels) / n,
        launches_per_frame={fn.__name__: fn.launches / n for fn in ops.KERNEL_WRAPPERS},
        families_ms_per_frame=dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:120], ms_per_frame=v, calls_per_frame=count[k] / n)
                     for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]],
    )
    print(f"{card}: {args.model} {args.dtype} quant={args.quant} frame latency median {res['latency_ms_median']:.3f} ms "
          f"(host clock, {n} frames); profiled {res['profiled_wall_ms_per_frame']:.3f} ms/frame, "
          f"device kernels {device_ms:.3f} ms/frame, busy share {res['device_busy_share']:.3f}, "
          f"{res['kernels_per_frame']:.0f} kernels/frame")
    for fam, ms in res["families_ms_per_frame"].items():
        print(f"  {fam:18s} {ms:9.4f} ms/frame")
    for k in res["top_kernels"]:
        print(f"  {k['ms_per_frame']:9.4f} ms  x{k['calls_per_frame']:5.1f}  {k['name']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
