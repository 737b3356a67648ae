"""Where a BEVFormer, BEVDet, YOLOX or CenterNet frame's time goes on the card.

    python -m bevformer_tensorrt_tpu_torch.tools.profile_frame [--model tiny]
        [--dtype float32] [--frames 5] [--quant none] [--exclude PATTERN ...]
        [--out FILE]

Runs BEVFormer tiny, small or base with seeded weights on synthetic frames of one scene through
`BEVFormerEngine`, or with `--model bevdet` BEVDet-R50 through `BEVDetEngine`
(the `interval` splat, ranks of a synthetic six-camera rig padded to 400000
points, the decode on the card; the host's Scale-NMS is not in the frame):
first the host-clock frame latency (each frame ends in a
synchronise), then a `torch.profiler` window over the same number of
frames.  With `--model yolox_x` or `--model centernet_r18` a "frame" is a batch
of 8 seeded 640x640 images through `Det2DEngine`, the decode on the
card (YOLOX's NMS and CenterNet's threshold run on the host and are not in
it; YOLOX's seeded stem conv is scaled by 1/64, for raw-pixel inputs).  Prints the device time per frame by kernel family and the top
kernels, the device busy share (the union of the kernels' intervals over
the profiled window's wall time) and the peak device memory the timed
frames allocated.  TF32 is off, as in chip_smoke.py.
With `--quant qdq` or `--quant int8` the model is calibrated first (`max`,
two frames); `--exclude self_attn/msda_tables dcn_tables` keeps a DCN
backbone's gather tables in floating point under int8.
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
from ..configs.bevdet import bevdet_r50
from .. import ops
from ..models.necks.view_transformer import get_lidar_coor, voxel_pooling_prepare
from ..runtime.bevdet_engine import BEVDetEngine
from ..runtime.det2d_engine import Det2DEngine, make_config
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import bevdet_rig, synthetic_frames
from .path_diff import QUANT, quant_overrides

FAMILIES = (  # first match wins
    ("int8 gemm kernel", r"int8_gemm_kernel"),
    ("msda int8 kernel", r"msda_kernel<signed char"),
    ("flash int8 kernel", r"flash_int8_kernel"),
    ("flash int8 quantize kernel", r"flash_int8_(amax|quantize)"),
    ("msda kernel", r"msda_kernel"),
    ("flash kernel", r"flash_kernel"),
    ("dcn int8 kernel", r"dcn_(wgmma|ffma)_kernel<[^>]*signed char"),
    ("dcn kernel", r"dcn_(wgmma|ffma)_kernel"),
    ("dcn table kernel", r"dcn_(table|amax)_kernel"),
    ("dcn im2col int8 kernel", r"dcn_im2col_kernel<signed char"),
    ("dcn im2col kernel", r"dcn_im2col_kernel"),
    ("memcpy", r"[Mm]emcpy|[Mm]emset"),
    # cuDNN's direct, implicit-GEMM and FFT convolutions; complex (cf32,
    # float2) kernels come only from the FFT convolutions in this model
    ("convolution", r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|cudnn|nchw|nhwc|cf32|float2"),
    ("matmul", r"gemm|nvjet|cutlass|splitK|Kernel2"),
    ("scan", r"scan|cumsum"),
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


def bevdet_frames(over, count):
    """`infer(i)`: frame i of `count` seeded images through a BEVDet-R50
    engine on a synthetic rig (calibrated, `max` over two frames, under a
    quantized tier)."""
    cfg = bevdet_r50(**over)
    rng = np.random.default_rng(0)
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, rng)
    ranks = voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=400000,
                                  pad_intervals_to=cfg.bev_h * cfg.bev_w)
    engine = BEVDetEngine(cfg, ranks, seed=0)
    images = [rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w))
              .astype(np.float32) for _ in range(count)]
    if cfg.quant:
        engine.calibrate(images[:2], method="max")
    return lambda i: engine.infer_frame(images[i])


DET2D_BATCH = 8  # images a YOLOX or CenterNet frame


def det2d_frames(model, over, count):
    """`infer(i)`: batch i of `count` seeded batches through a YOLOX-x or
    CenterNet-R18 engine (calibrated, `max` over two batches, under a
    quantized tier)."""
    cfg = make_config(model, **over)
    engine = Det2DEngine(cfg, seed=0)
    if model.startswith("yolox"):
        with torch.no_grad():
            engine.model.backbone.stem.conv.conv.weight.mul_(1 / 64)
    rng = np.random.default_rng(0)
    scale = 255.0 if model.startswith("yolox") else 1.0
    images = [(rng.random((DET2D_BATCH, 3, cfg.img_size, cfg.img_size)) * scale).astype(np.float32)
              for _ in range(count)]
    if cfg.quant:
        engine.calibrate(images[:2], method="max")
    return lambda i: engine.infer(images[i])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny",
                    choices=("tiny", "small", "base", "bevdet", "yolox_x", "centernet_r18"))
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
    over = dict(dtype=args.dtype, **quant_overrides(args.quant, args.exclude))
    count = 2 * args.frames + 2
    if args.model == "bevdet":
        infer = bevdet_frames(over, count)
    elif args.model in ("yolox_x", "centernet_r18"):
        infer = det2d_frames(args.model, over, count)
    else:
        cfg = getattr(configs, f"bevformer_{args.model}")(**over)
        engine = BEVFormerEngine(cfg, seed=0)
        frames = synthetic_frames(cfg, np.random.default_rng(0), ["scene"] * count)
        if cfg.quant:
            engine.calibrate(frames[:2], method="max")

        def infer(i):
            engine.infer_frame(**frames[i])

    for i in range(2):  # warm-up
        infer(i)
    torch.cuda.synchronize()

    lat = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2, 2 + args.frames):
        t0 = time.perf_counter()
        infer(i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2 + args.frames, count):
            infer(i)
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
        batch=DET2D_BATCH if args.model in ("yolox_x", "centernet_r18") else 1,
        latency_ms_median=float(np.median(lat)), latency_ms=lat, peak_memory_mb=peak_mb,
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
          f"{res['kernels_per_frame']:.0f} kernels/frame, peak device memory {peak_mb:.0f} MB")
    for fam, ms in res["families_ms_per_frame"].items():
        print(f"  {fam:18s} {ms:9.4f} ms/frame")
    for k in res["top_kernels"]:
        print(f"  {k['ms_per_frame']:9.4f} ms  x{k['calls_per_frame']:5.1f}  {k['name']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
