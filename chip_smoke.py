#!/usr/bin/env python3
"""Drive the PyTorch port of BEVFormer on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero before the result lines):
  0. Print the card, torch and CUDA versions; build every kernel of the
     port with nvcc (sm_90a), all sources at once; TF32 off.
  1. MSDA kernel vs its plain version on the card, at the three shapes of
     BEVFormer-tiny's main path (temporal self-attention, spatial
     cross-attention, decoder cross-attention) and one 4-level base-like
     shape, float32 and bfloat16, with samples past every border.
  2. Flash-attention kernel vs its plain version: (8, 900, 32), a ragged
     length and head dim 64, float32 and bfloat16;
     `scaled_dot_product_attention` is timed beside it as a yardstick.
  3. BEVFormer-tiny at full width through `BEVFormerEngine`, seeded weights,
     6 random images on a 6-camera rig: three frames (new scene, temporal,
     scene change) with the launch counts set to 0 just before and read
     just after; then the same frames through the plain versions on the
     card, which must agree; the frame latency; one bfloat16 pass.
  4. One JSON line of per-kernel numbers, the nvidia-smi line of the card,
     and the final `{"ok": true, "device": ...}` line.

Kernel times are CUDA-event times of back-to-back launches queued behind a
device sleep, so host overhead is not counted.  Bounds use the H100 SXM
published peaks: 3.35 TB/s, 67 TFLOP/s float32, 989 TFLOP/s bfloat16.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_tiny
from bevformer_tensorrt_tpu_torch.core.nms_free_coder import NMSFreeCoder
from bevformer_tensorrt_tpu_torch.models.modules.encoder import cam_budget_overflow
from bevformer_tensorrt_tpu_torch.ops import _cuda, reset_launch_counts
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SLEEP_CYCLES = 20_000_000  # ~10 ms of device sleep ahead of a timed batch

MSDA_SHAPES = {
    # name: (bs, spatial_shapes, nq, P, ppg, launches per tiny frame)
    "tsa": (2, ((50, 50),), 2500, 4, 1, 3),
    "sca": (6, ((15, 25),), 896, 8, 4, 3),
    "decoder": (1, ((50, 50),), 900, 4, 1, 6),
    "base4": (6, ((116, 200), (58, 100), (29, 50), (15, 25)), 14080, 8, 4, 0),
}
FLASH_SHAPES = {
    # name: (B, Lq, Lk, d, launches per tiny frame)
    "decoder": (8, 900, 900, 32, 6),
    "ragged": (8, 777, 611, 32, 0),
    "d64": (8, 900, 900, 64, 0),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # max abs err / max |plain|
F32_MAX_TOL = 1e-4   # end to end, float32: summation order only (and index_add_ atomics)
BF16_RMS_TOL = 5e-2  # end to end, bfloat16, in the rms norm (see phase_tiny)


def log(*a):
    print(*a, flush=True)


def device_ms(fn, n=20, repeats=5):
    """Median over `repeats` of the mean device time of `n` back-to-back
    calls, queued behind a device sleep so the host never starves the card."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / n)
    return float(np.median(out))


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, dtype, what):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not np.isfinite(err) or err > TOL[dtype] * max(scale, 1e-12):
        raise AssertionError(f"{what}: max abs err {err} vs max |plain| {scale}")
    return err


def msda_inputs(name, dtype, gen, dev):
    bs, shapes, nq, P, ppg, _ = MSDA_SHAPES[name]
    H, ch, L = 8, 32, len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = torch.randn(bs, keys, H, ch, generator=gen)
    ref = torch.rand(bs, nq, 1, 2 * ppg, generator=gen) * 1.2 - 0.1
    off = torch.randn(bs, nq, H, L * P * 2, generator=gen) * 3
    far = torch.rand(off.shape, generator=gen) < 0.05  # well past the borders
    off = torch.where(far, torch.sign(off) * 300.0, off)
    attn = torch.randn(bs, nq, H, L * P, generator=gen)
    return ([t.to(dev, dtype) for t in (value,)] + [ref.to(dev)]
            + [t.to(dev, dtype) for t in (off, attn)]), shapes


def phase_msda(dev, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in MSDA_SHAPES.items():
            (value, ref, off, attn), shapes = msda_inputs(name, dtype, gen, dev)
            got = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes)
            want = msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"msda {name} {dtype}")
            bs, _, nq, P, _, per_frame = spec
            H, ch, L, esz = 8, 32, len(shapes), value.element_size()
            nbytes = ((value.numel() + off.numel() + attn.numel()) * esz + ref.numel() * 4
                      + bs * nq * H * ch * esz)
            flops = bs * nq * H * L * P * 4 * ch * 2
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms = device_ms(lambda: msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes))
            plain_ms = device_ms(
                lambda: msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes),
                n=3, repeats=3)
            row = dict(shape=name, dtype=str(dtype).split(".")[-1], bs=bs, nq=nq, levels=shapes,
                       P=P, launches_per_frame=per_frame, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"msda {name:8s} {row['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
    return rows


def phase_flash(dev, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, Lq, Lk, d, per_frame) in FLASH_SHAPES.items():
            q = torch.randn(B, Lq, d, generator=gen).to(dev, dtype)
            k = torch.randn(B, Lk, d, generator=gen).to(dev, dtype)
            v = torch.randn(B, Lk, d, generator=gen).to(dev, dtype)
            got = attn_ops.flash_attention(q, k, v)
            want = attn_ops.qkv_plain(q, k, v)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"flash {name} {dtype}")
            esz = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
            b_ms, b_by = bound(nbytes, 4 * B * Lq * Lk * d, dtype)
            ms = device_ms(lambda: attn_ops.flash_attention(q, k, v))
            plain_ms = device_ms(lambda: attn_ops.qkv_plain(q, k, v), n=5)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            row = dict(shape=name, dtype=str(dtype).split(".")[-1], B=B, Lq=Lq, Lk=Lk, d=d,
                       launches_per_frame=per_frame, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            rows.append(row)
            log(f"flash {name:8s} {row['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
    return rows


def run_frames(engine, frames):
    engine.reset()
    outs = []
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        outs.append((engine.state.prev_bev.clone(), classes, coords))
    torch.cuda.synchronize()
    return outs


def run_plain(engine, frames):
    """The same frames with the kernel wrappers swapped for their plain
    versions (the port itself never sends a CUDA tensor to them)."""
    saved = msda_ops.multi_scale_deformable_attn, attn_ops.flash_attention
    msda_ops.multi_scale_deformable_attn = msda_ops.multi_scale_deformable_attn_plain
    attn_ops.flash_attention = attn_ops.qkv_plain
    try:
        return run_frames(engine, frames)
    finally:
        msda_ops.multi_scale_deformable_attn, attn_ops.flash_attention = saved


def compare_frames(got, want, what, max_tol=None, rms_tol=None):
    """Worst relative errors over the frames' bev_embed, classes and coords:
    "max" = max |a - b| / max |b| and "rms" = ||a - b|| / ||b||.  Raises
    above a given tolerance or on non-finite values."""
    worst = {"max": 0.0, "rms": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("bev_embed", "classes", "coords"), g, w):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{what} frame {i} {name}: non-finite values")
            d, b = (a - b).float(), b.float()
            r = {"max": float(d.abs().max() / b.abs().max().clamp_min(1e-12)),
                 "rms": float(d.norm() / b.norm().clamp_min(1e-12))}
            log(f"  {what} frame {i} {name:9s} rel err max {r['max']:.3e} rms {r['rms']:.3e}")
            for key, tol in (("max", max_tol), ("rms", rms_tol)):
                if tol is not None and r[key] > tol:
                    raise AssertionError(f"{what} frame {i} {name}: {key} rel err {r[key]} > {tol}")
                worst[key] = max(worst[key], r[key])
    return worst


def phase_tiny(card):
    cfg = bevformer_tiny()
    rng = np.random.default_rng(0)
    frames = synthetic_frames(cfg, rng, ("scene-A", "scene-A", "scene-B"))
    visible, overflow = cam_budget_overflow(cfg, frames[0]["lidar2img"])
    log(f"tiny rig: visible BEV queries per camera {visible.tolist()}, overflow {overflow}")
    if (visible == 0).any() or overflow > 0:
        raise AssertionError("the rig must show every camera some BEV queries within K")
    engine = BEVFormerEngine(cfg, seed=0)
    nq, C = cfg.bev_h * cfg.bev_w, cfg.embed_dims

    run_frames(engine, frames[:1])  # warm-up: cuDNN's algorithm choice, the allocator
    reset_launch_counts()
    per_frame = []
    engine.reset()
    outs = []
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        outs.append((engine.state.prev_bev.clone(), classes, coords))
        per_frame.append((msda_ops.multi_scale_deformable_attn.launches,
                          attn_ops.flash_attention.launches))
    torch.cuda.synchronize()
    launches = {"msda": msda_ops.multi_scale_deformable_attn.launches,
                "flash_attn": attn_ops.flash_attention.launches}
    log(f"tiny main path: cumulative launches after each frame (msda, flash) {per_frame}")
    if per_frame != [(12 * i, 6 * i) for i in (1, 2, 3)]:
        raise AssertionError(f"expected 12 MSDA and 6 flash launches per frame, got {per_frame}")

    shapes = tuple(tuple(t.shape) for t in outs[-1])
    if shapes != ((nq, 1, C), (6, 1, 900, 10), (6, 1, 900, 10)):
        raise AssertionError(f"tiny output shapes {shapes}")
    classes, coords = outs[-1][1:]
    dets = NMSFreeCoder().decode(classes, coords)
    log(f"tiny decode: {len(dets[0]['scores_3d'])} boxes in range of 300")

    plain = run_plain(engine, frames)
    err32 = compare_frames(outs, plain, "tiny f32 kernel vs plain", max_tol=F32_MAX_TOL)

    bench = [dict(f, scene_token="scene-A") for f in (frames * 4)[:11]]
    lat = []
    engine.reset()
    for i, f in enumerate(bench):
        t0 = time.perf_counter()
        engine.infer_frame(**f)
        torch.cuda.synchronize()
        if i >= 1:
            lat.append((time.perf_counter() - t0) * 1e3)
    latency = float(np.median(lat))
    log(f"tiny f32 frame latency: median {latency:.3f} ms over {len(lat)} frames "
        f"(min {min(lat):.3f}, max {max(lat):.3f}) on {card}")

    # bfloat16, same weights: in bfloat16 one-ulp rounding differences grow
    # through the layers and the random-weight decoder amplifies the worst
    # elements (max rel err 0.05-0.13 between the two paths), so bfloat16 is
    # held in the rms norm: the kernel path agrees with the plain path, and
    # strays from the float32 result no further than the plain path does
    engine16 = BEVFormerEngine(bevformer_tiny(dtype="bfloat16"), seed=0)
    got16 = run_frames(engine16, frames)
    plain16 = run_plain(engine16, frames)
    err16 = compare_frames(got16, plain16, "tiny bf16 kernel vs plain", rms_tol=BF16_RMS_TOL)
    drift_k = compare_frames(got16, plain, "tiny bf16 kernel vs f32 plain")["rms"]
    drift_p = compare_frames(plain16, plain, "tiny bf16 plain vs f32 plain")["rms"]
    if drift_k > 1.5 * drift_p + 1e-3:
        raise AssertionError(f"bf16 kernel path drifts {drift_k} from float32, plain path {drift_p}")
    return dict(launches=launches, frames=len(frames), rel_err_f32=err32, rel_err_bf16=err16,
                bf16_drift_kernel=drift_k, bf16_drift_plain=drift_p,
                latency_ms_median=latency, latency_ms=lat)


def kernel_entry(name, source, replaces, launches, rows, library):
    """One entry of the kernels line: the main path's float32 launches of
    one tiny frame at their shapes, summed (ms per frame)."""
    main = [r for r in rows if r["dtype"] == "float32" and r["launches_per_frame"]]

    def tot(key):
        return float(sum(r[key] * r["launches_per_frame"] for r in main))

    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "launches_per_frame": sum(r["launches_per_frame"] for r in main),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_us": tot("bound_ms") * 1e3,
        "bound_by": max(main, key=lambda r: r["bound_ms"] * r["launches_per_frame"])["bound_by"],
        "library_ms": tot("library_ms") if library else None,
        "per": "one tiny frame: the sum over its float32 launches at the main path's shapes",
        "shapes": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the detailed results as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_logs = _cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.2f} s: {sorted(build_logs)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    msda_rows = phase_msda(dev, gen)
    flash_rows = phase_flash(dev, gen)
    tiny = phase_tiny(card)

    kernels = [
        kernel_entry("msda", "bevformer_tensorrt_tpu_torch/csrc/msda.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247",
                     tiny["launches"]["msda"], msda_rows, library=False),
        kernel_entry("flash_attn", "bevformer_tensorrt_tpu_torch/csrc/flash_attn.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/flash_attn.py:183",
                     tiny["launches"]["flash_attn"], flash_rows, library=True),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           build_s=build_s, kernels=kernels, tiny=tiny), fh, indent=1)
    summary = [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]
    log(json.dumps({"kernels": summary}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
