"""A / B of the BEV pool's formulations at BEVDet-R50's ranks (port of
`tools/bevpool_ab.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.bevpool_ab [--model r50] [--iters 20]
        [--device cpu] [--out FILE]

Times `ops/bev_pool.py::bev_pool_v2` in its two modes, `scatter` (one
index-add of the P contributions) and `interval` (a float32 prefix sum,
interval differences, one scatter of unique cells), over pad {tight (the
rig's in-grid points rounded up to 8192), 400000} x contribution dtype
{float32, bfloat16}, on the ranks of a six-camera rig (identity extrinsics,
focal 800, as the JAX tool's).  Each variant's error is its largest
absolute difference from a float64 splat of the same inputs.

Timing: CUDA events around back-to-back calls queued behind a device sleep,
the median over repeats (`kernel_cases.device_ms`).  That replaces the JAX
tool's chained slope, which cancels the TPU's ~28 ms dispatch floor; so
`--k` (the chain's length) is not ported.  Not ported either: the
`scatter_sorted` variant, which passes XLA's `indices_are_sorted` hint to
its scatter; `index_add_` takes no such hint.  On the CPU the times are the
host clock (a rehearsal).  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..configs.bevdet import bevdet_micro, bevdet_r50
from ..models.necks.view_transformer import get_lidar_coor, voxel_pooling_prepare
from ..ops.bev_pool import bev_pool_v2
from ..runtime.engine import resolve_device
from .accuracy_cycle import device_name
from .kernel_cases import call_ms

IMPLS = ("scatter", "interval")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def rig_ranks(cfg, pad: str):
    """PoolingRanks of the JAX tool's rig: identity sensor2ego, focal 800."""
    N = cfg.num_cams
    s2e = np.broadcast_to(np.eye(4, dtype=np.float32), (N, 4, 4)).copy()
    intr = np.stack([np.array([[800.0, 0, cfg.input_w / 2], [0, 800.0, cfg.input_h / 2],
                               [0, 0, 1]], np.float32)] * N)
    coor = get_lidar_coor(cfg, s2e, intr)
    npts = int(np.prod(coor.shape[:-1]))
    tight = -(-npts // 8192) * 8192
    gz = int(round((cfg.grid_zbound[1] - cfg.grid_zbound[0]) / cfg.grid_zbound[2]))
    pad_to = tight if pad == "tight" else max(400000, tight)
    return voxel_pooling_prepare(cfg, coor, pad_to=pad_to,
                                 pad_intervals_to=cfg.bev_h * cfg.bev_w * gz), tight


def inputs(cfg, device):
    """Seeded depth [N, D, h, w] and features [N, h, w, C], float32 (the JAX
    tool's generator)."""
    rng = np.random.default_rng(0)
    hf, wf = cfg.input_h // 16, cfg.input_w // 16
    depth = rng.random((cfg.num_cams, cfg.depth_bins, hf, wf)).astype(np.float32)
    feat = rng.standard_normal((cfg.num_cams, hf, wf, cfg.view_channels)).astype(np.float32)
    return torch.as_tensor(depth, device=device), torch.as_tensor(feat, device=device)


def variants(cfg, device):
    """Yield (name, call) for every impl x pad x dtype; a call returns the
    [1, H, W, C] splat."""
    depth, feat = inputs(cfg, device)
    for pad in ("tight", "400k"):
        ranks, _ = rig_ranks(cfg, pad)
        r = [torch.as_tensor(a, device=device) for a in (
            ranks.ranks_depth, ranks.ranks_feat, ranks.ranks_bev, ranks.interval_starts,
            ranks.interval_lengths)]
        for impl in IMPLS:
            for dname, dt in DTYPES.items():
                d, f = depth.to(dt), feat.to(dt)

                def call(d=d, f=f, r=r, impl=impl):
                    return bev_pool_v2(d, f, *r, out_height=cfg.bev_h, out_width=cfg.bev_w,
                                       impl=impl)
                yield f"{impl}/{pad}/{dname}", call


def reference(cfg, device) -> torch.Tensor:
    """The float64 splat of the same inputs (tight ranks; pads add nothing)."""
    depth, feat = inputs(cfg, device)
    ranks, _ = rig_ranks(cfg, "tight")
    r = [torch.as_tensor(a, device=device) for a in (
        ranks.ranks_depth, ranks.ranks_feat, ranks.ranks_bev)]
    return bev_pool_v2(depth.double(), feat.double(), *r, out_height=cfg.bev_h,
                       out_width=cfg.bev_w, impl="scatter")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported from the JAX CLI: --k, scatter_sorted.")
    ap.add_argument("--model", default="r50", choices=("r50", "micro"))
    ap.add_argument("--iters", type=int, default=20, help="calls a timed batch")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = bevdet_r50() if args.model == "r50" else bevdet_micro()
    ref = reference(cfg, dev)
    results, errors = {}, {}
    with torch.inference_mode():
        for name, call in variants(cfg, dev):
            errors[name] = float((call().double() - ref).abs().max())
            results[name] = call_ms(call, dev, n=args.iters)
            print(f"{name:22s} {results[name]:8.4f} ms/op  max abs err vs float64 "
                  f"{errors[name]:.3e}", flush=True)
    _, tight = rig_ranks(cfg, "tight")
    rec = {"model": args.model, "points_tight": tight, "results": results,
           "max_abs_err_vs_float64": errors, "ref_max_abs": float(ref.abs().max()),
           "device": device_name(dev)}
    print(rec["device"])
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
