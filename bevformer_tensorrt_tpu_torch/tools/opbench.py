"""Per-op benchmark table: op family x tier in ms an op (port of
`tools/opbench.py`), the analogue of the reference's per-plugin speedup table
(TensorRT/README.md:7-253).

    python -m bevformer_tensorrt_tpu_torch.tools.opbench [--iters 20] [--out OPBENCH.md]
        [--device cpu] [--toy]

Families at the JAX tool's base-tier deploy shapes: MSDA (the spatial
cross-attention: 6 cameras x 14080 compacted queries over 4 levels, pillar
reference points sorted by the middle anchor's raster position), DCNv2 (a
stage-3 block of R101, NHWC 6 x 58 x 100 x 256), bev_pool_v2 (BEVDet-R50:
400000 random ranks, sorted cells) and flash (the decoder's self-attention,
8 x 960 x 32); tiers float32, bfloat16 and int8 where the op has them
(MSDA's int8 value table, the DCN's int8 table, int8 flash; the BEV pool has
no int8 form).  The speedup is against the family's first tier.

Timing: CUDA events around back-to-back calls queued behind a device sleep,
the median over repeats (`kernel_cases.device_ms`).  That replaces the JAX
tool's chained slope, which cancels the TPU's ~28 ms dispatch floor: a
CUDA launch has no such floor, so `--k` is not ported; nor are the JAX
table's grid_sample, rotate and XLA qkv rows, which are not kernels of the
port.  `--toy` takes the
families at a few hundredth of their size (a rehearsal; the CPU's host
clock).  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..configs.bevdet import bevdet_r50
from ..ops import attention, dcn, msda
from ..ops.bev_pool import bev_pool_v2
from ..runtime.engine import resolve_device
from .accuracy_cycle import device_name
from .kernel_cases import call_ms

TIERS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def msda_case(dev, toy: bool):
    """(value, ref, off, attn, shapes): the cross-attention at base, the
    JAX tool's pillar geometry and draws (seed 0)."""
    rng = np.random.default_rng(0)
    cams, heads, ch, L, P, ppg = 6, 8, 32, 4, 8, 4
    shapes = ((116, 200), (58, 100), (29, 50), (15, 25)) if not toy else ((8, 12), (4, 6))
    nq = 14080 if not toy else 128
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = rng.standard_normal((cams, keys, heads, ch)).astype(np.float32)
    base_x = rng.uniform(0.02, 0.98, (cams, nq, 1)).astype(np.float32)
    base_y = rng.uniform(0.1, 0.9, (cams, nq, 1)).astype(np.float32)
    zoff = np.linspace(-0.08, 0.08, ppg, dtype=np.float32).reshape(1, 1, ppg)
    ref = np.stack([np.broadcast_to(base_x, (cams, nq, ppg)),
                    np.clip(base_y + zoff, 0.02, 0.98)], axis=-1).reshape(cams, nq, ppg * 2)
    H0, W0 = shapes[0]
    order = np.argsort(np.floor(ref[..., 2 * (ppg // 2) + 1] * H0) * W0
                       + np.floor(ref[..., 2 * (ppg // 2)] * W0), axis=1)
    ref = np.take_along_axis(ref, order[..., None], axis=1).astype(np.float32)
    off = (rng.standard_normal((cams, nq, heads, L * P * 2)) * 2).astype(np.float32)
    attn = rng.standard_normal((cams, nq, heads, L * P)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(value), t(ref[:, :, None, :].copy()), t(off), t(attn), shapes


def run(dev, iters: int, toy: bool = False) -> list:
    """Rows (family, tier, ms an op)."""
    rows = []

    def add(family, tier, fn):
        ms = call_ms(fn, dev, n=iters)
        rows.append((family, tier, ms))
        print(f"{family:24s} {tier:9s} {ms:9.4f} ms", flush=True)

    value, ref, off, attn, shapes = msda_case(dev, toy)
    for tier in ("float32", "bfloat16", "int8"):
        dt = torch.bfloat16 if tier == "bfloat16" else torch.float32
        args = (value.to(dt), ref, off.to(dt), attn.to(dt), shapes)
        fn = msda.multi_scale_deformable_attn_int8 if tier == "int8" else \
            msda.multi_scale_deformable_attn
        add("msda (cross)", tier, lambda fn=fn, args=args: fn(*args))

    rng = np.random.default_rng(0)
    N, Cin, H, W, Cout = (6, 256, 58, 100, 256) if not toy else (1, 32, 6, 8, 32)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = t(rng.standard_normal((N, H, W, Cin)))
    offm = t(rng.standard_normal((N, H, W, 18)) * 2)
    maskm = t(rng.uniform(0, 1, (N, H, W, 9)))
    wgt = t(rng.standard_normal((Cout, Cin, 3, 3)) * 0.05)
    for tier in ("float32", "bfloat16", "int8"):
        dt = torch.bfloat16 if tier == "bfloat16" else torch.float32
        args = tuple(a.to(dt) for a in (x, offm, maskm, wgt))
        wmat = dcn.dcn_weight_matrix(args[3], dt) if dev.type == "cuda" else None
        q = "int8" if tier == "int8" else False
        add("dcn_v2 (c4)", tier, lambda args=args, q=q, wmat=wmat: dcn.modulated_deform_conv2d(
            *args, layout="NHWC", quant=q, wmat=wmat))

    cfg = bevdet_r50()
    D, fh, fw, Cv = cfg.depth_bins, cfg.input_h // 16, cfg.input_w // 16, cfg.view_channels
    if toy:
        D, fh, fw, Cv = 8, 4, 6, 16
    n_in = 400000 if not toy else 4000
    npts = 6 * D * fh * fw
    cells = cfg.bev_h * cfg.bev_w
    rd = torch.as_tensor(rng.integers(0, npts, n_in), device=dev)
    rf = torch.as_tensor(rng.integers(0, 6 * fh * fw, n_in), device=dev)
    rb = torch.as_tensor(np.sort(rng.integers(0, cells, n_in)), device=dev)
    depth = t(rng.uniform(0, 1, (6, D, fh, fw)))
    feat = t(rng.standard_normal((6, fh, fw, Cv)))
    for tier, dt in TIERS.items():
        d, f = depth.to(dt), feat.to(dt)
        add("bev_pool_v2 (r50)", tier, lambda d=d, f=f: bev_pool_v2(
            d, f, rd, rf, rb, out_height=cfg.bev_h, out_width=cfg.bev_w))

    B, qlen, dh = (8, 960, 32) if not toy else (2, 64, 32)
    q = t(rng.standard_normal((B, qlen, dh)))
    for tier in ("float32", "bfloat16", "int8"):
        x = q.to(torch.bfloat16 if tier == "bfloat16" else torch.float32)
        fn = attention.flash_attention_int8 if tier == "int8" else attention.flash_attention
        add("flash_mha (decoder)", tier, lambda fn=fn, x=x: fn(x, x, x))
    return rows


def table(rows, device: str) -> list:
    lines = ["| op family | tier | ms/op | speedup vs first tier |", "|---|---|---|---|"]
    first = {}
    for fam, tier, ms in rows:
        sp = "" if fam not in first else f"{first[fam] / ms:.2f}x"
        first.setdefault(fam, ms)
        lines.append(f"| {fam} | {tier} | {ms:.4f} | {sp} |")
    return [f"Device: {device}.  CUDA events, median over repeats (port "
            "`tools/opbench.py`); the JAX package's base-tier deploy shapes.", ""] + lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported from the JAX CLI: --k.")
    ap.add_argument("--iters", type=int, default=20, help="calls a timed batch")
    ap.add_argument("--out", default=None, help="write the markdown table here")
    ap.add_argument("--toy", action="store_true", help="small stand-ins (a rehearsal)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with torch.inference_mode():
        rows = run(dev, args.iters, args.toy)
    device = device_name(dev)
    lines = table(rows, device)
    print("\n".join(lines))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    rec = {"device": device, "rows": [{"family": f, "tier": t, "ms": ms} for f, t, ms in rows]}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
