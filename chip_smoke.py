#!/usr/bin/env python3
"""Drive the PyTorch port of BEVFormer on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero before the result lines):
  0. Print the card, torch and CUDA versions; build every kernel of the
     port with nvcc (sm_90a), all sources at once; TF32 off.
  1. MSDA kernel vs its plain version on the card, at the shapes of the
     main paths of BEVFormer-tiny and BEVFormer-base (temporal
     self-attention, spatial cross-attention, decoder cross-attention),
     float32 and bfloat16, with samples past every border.
  2. Flash-attention kernel vs its plain version: (8, 900, 32), a ragged
     length and head dim 64, float32 and bfloat16;
     `scaled_dot_product_attention` is timed beside it as a yardstick.
  3. DCNv2: the deformable im2col kernel and the whole op vs their plain
     versions at the stage-3 and stage-4 shapes of base and small and one
     shape with stride 2, two deform groups and a ragged size, float32 and
     bfloat16, offsets past every border; cuDNN's ordinary `F.conv2d` of
     the same shape is timed beside it as a yardstick.
  4. BEVFormer-tiny at full width through `BEVFormerEngine`, seeded weights,
     6 random images on a 6-camera rig: three frames (new scene, temporal,
     scene change) with the launch counts set to 0 just before and read
     just after; then the same frames through the plain versions on the
     card, which must agree; the frame latency; one bfloat16 pass.
  5. BEVFormer-base at full width (R101 with DCN, four levels, 200x200 BEV),
     the same way: exactly 18 MSDA, 6 flash and 26 DCN launches per frame.
  6. One BEVFormer-small frame at full width: 12 / 6 / 26 launches.
  7. The int8 product kernel vs its plain version (bit for bit) at named
     shapes of the quantized path: dense layers, a 1x1 and a 3x3 convolution
     with K = 4608 as matrices, and the odd shapes K = 18, K = 147, N = 3;
     `torch._int_mm` is timed beside it as a yardstick where it takes the
     shape.
  8. MSDA from int8 value tables vs its plain version at the SCA and decoder
     shapes of tiny and base, the kernel alone and with the quantization.
  9. int8 flash attention vs its plain version at (8, 900, 32), a ragged
     length and head dim 64.
 10. BEVFormer-tiny under quant="int8", default policy, at full width:
     calibrate the QDQ tier on the card over four synthetic frames (`max`
     and `entropy` both run; `entropy` is used), attach and fold the scales
     into the int8 tier, then three frames on the kernel path (launch counts
     asserted: one int8 product per dense or conv layer, 9 int8-table and 3
     floating-point MSDA, 6 int8 flash, no floating-point flash) against the
     same frames on the plain path, against the QDQ simulation and against
     floating point; the frame latency with float32 and bfloat16
     activations; and the int8 product timed at every shape the frame
     launched.
 11. BEVFormer-base under quant="int8" with `dcn_tables` excluded, the same
     way with fewer frames: 12 int8-table and 6 floating-point MSDA, 6 int8
     flash, 26 DCN launches per frame.
 12. One JSON line of per-kernel numbers, the nvidia-smi line of the card,
     and the final `{"ok": true, "device": ...}` line.

Kernel times are CUDA-event times of back-to-back launches queued behind a
device sleep, so host overhead is not counted.  Bounds use the H100 SXM
published peaks: 3.35 TB/s, 67 TFLOP/s float32, 989 TFLOP/s bfloat16,
1979 TOP/s int8.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu_torch.configs.bevformer import (
    bevformer_base,
    bevformer_small,
    bevformer_tiny,
)
from bevformer_tensorrt_tpu_torch.core.nms_free_coder import NMSFreeCoder
from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense
from bevformer_tensorrt_tpu_torch.models.modules.encoder import cam_budget_overflow
from bevformer_tensorrt_tpu_torch.ops import KERNEL_WRAPPERS, _cuda, reset_launch_counts
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames
from bevformer_tensorrt_tpu_torch.tools.path_diff import plain_versions, rel_errors, run_frames

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
SLEEP_CYCLES = 20_000_000  # ~10 ms of device sleep ahead of a timed batch

MSDA_SHAPES = {
    # name: (bs, spatial_shapes, nq, P, ppg, launches per tiny frame, per base frame)
    "tsa": (2, ((50, 50),), 2500, 4, 1, 3, 0),
    "sca": (6, ((15, 25),), 896, 8, 4, 3, 0),
    "decoder": (1, ((50, 50),), 900, 4, 1, 6, 0),
    "tsa_base": (2, ((200, 200),), 40000, 4, 1, 0, 6),
    "base4": (6, ((116, 200), (58, 100), (29, 50), (15, 25)), 14080, 8, 4, 0, 6),
    "decoder_base": (1, ((200, 200),), 900, 4, 1, 0, 6),
}
FLASH_SHAPES = {
    # name: (B, Lq, Lk, d, launches per tiny frame, per base frame)
    "decoder": (8, 900, 900, 32, 6, 6),
    "ragged": (8, 777, 611, 32, 0, 0),
    "d64": (8, 900, 900, 64, 0, 0),
}
DCN_SHAPES = {
    # name: (N, Cin, H, W, Cout, stride, deform groups, launches per base frame, per small frame)
    "base_s3": (6, 256, 58, 100, 256, 1, 1, 23, 0),
    "base_s4": (6, 512, 29, 50, 512, 1, 1, 3, 0),
    "small_s3": (6, 256, 46, 80, 256, 1, 1, 0, 23),
    "small_s4": (6, 512, 23, 40, 512, 1, 1, 0, 3),
    "ragged": (2, 48, 37, 53, 40, 2, 2, 0, 0),
}
MSDA_INT8_SHAPES = {
    # int8 tables: SCA and decoder (TSA's stay floating point by the default policy);
    # name: (shape of MSDA_SHAPES, launches per tiny int8 frame, per base int8 frame)
    "sca": ("sca", 3, 0), "decoder": ("decoder", 6, 0),
    "base4": ("base4", 0, 6), "decoder_base": ("decoder_base", 0, 6),
}
GEMM_SHAPES = {
    # name: (M, K, N): x [M, K] int8, w [N, K] int8
    "dense_decoder": (900, 256, 256),          # every decoder / head projection
    "dense_bev_ffn": (2500, 256, 512),         # tiny encoder FFN fc1
    "dense_bev_base": (40000, 256, 256),       # base encoder projections
    "conv1x1_base_s2": (34800, 256, 1024),     # R101 stage-2 conv3 at base, 6 x 58 x 100
    "conv3x3_k4608": (2250, 4608, 512),        # R50 stage-4 conv2 at tiny, 6 x 15 x 25
    "conv3x3_base_s1": (556800, 576, 64),      # R101 stage-1 conv2 at base, 6 x 232 x 400
    "can_bus_k18": (1, 18, 128),
    "stem_k147": (576000, 147, 64),            # tiny's 7x7 stem, 6 x 240 x 400
    "reference_points_n3": (900, 256, 3),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # max abs err / max |plain|
FLASH_INT8_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # a flipped round(p * 127)
# int8 frames, kernel path against plain path.  The integer products are
# exact, so the backbone and neck must agree bit for bit.  Past the first MSDA
# launch a float32 difference of 1e-6 can put an activation on the other side
# of a rounding boundary, one step of its scale away, and every decoder layer
# grows that (tools/path_diff.py --quant int8: with only the floating-point
# MSDA kernel on, 1e-6 from its plain version, tiny's coords differ by 1.1e-2
# rms after the first decoder layer and 6.4e-2 after the sixth; with only the
# int8 product on its kernel, by exactly 0).  So the outputs are held in the
# rms norm by bars about twice what was measured (BEV embedding 1.0e-2 tiny /
# 2.5e-2 base, classes 1.4e-2, coords 3.6e-2 / 5.9e-2; the first guesses, rms
# 2e-2 and a mean coordinate difference of 0.05, failed), and the mean
# |coords - coords'| between the paths and against the QDQ simulation (tiny
# 0.11 / 0.13, base 0.23 / 0.24; the JAX package holds 0.05 at micro width
# with one decoder layer, tests/test_quant.py) by 0.5.  Quantization itself
# moves the coordinates by 0.80 at tiny and 0.30 at base: at base the
# rounding noise between two int8 paths is nearly what quantization costs.
INT8_TOLS = {"bev_embed": dict(rms=5e-2), "classes": dict(rms=5e-2), "coords": dict(rms=0.15)}
INT8_COORDS_TOL = 0.5
F32_MAX_TOL = 1e-4   # end to end, float32: summation order only (and index_add_ atomics)
# Base, float32: the BEV embedding and the first decoder layer hold 1e-4, but
# each of base's decoder layers multiplies a one-ulp difference by about 4
# (tiny's by about 2; tools/path_diff.py: the flash kernel alone, 4e-7 from
# its plain version, ends at 2e-4 in layer 6), so the outputs of all six
# layers are held in the rms norm and by a wider max bar
BASE_F32_TOL = {"bev_embed": dict(max=1e-4), "classes": dict(max=5e-3, rms=1e-3),
                "coords": dict(max=5e-3, rms=1e-3)}
BF16_RMS_TOL = 5e-2  # end to end, bfloat16, in the rms norm (see phase_model)


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


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def msda_inputs(name, dtype, gen, dev):
    bs, shapes, nq, P, ppg = MSDA_SHAPES[name][:5]
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
            bs, _, nq, P, _, per_tiny, per_base = spec
            H, ch, L, esz = 8, 32, len(shapes), value.element_size()
            # the rows this run's queries can gather (one ch-wide row per corner)
            # where they are fewer than the value table
            gathered = min(value.numel(), bs * nq * H * L * P * 4 * ch)
            nbytes = ((gathered + off.numel() + attn.numel()) * esz + ref.numel() * 4
                      + bs * nq * H * ch * esz)
            flops = bs * nq * H * L * P * 4 * ch * 2
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms = device_ms(lambda: msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes))
            plain_ms = device_ms(
                lambda: msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes),
                n=3, repeats=3)
            row = dict(shape=name, dtype=dtype_name(dtype), bs=bs, nq=nq, levels=shapes,
                       P=P, launches_per_frame={"tiny": per_tiny, "base": per_base},
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       value_table_mb=value.numel() * esz / 1e6, gathered_mb=gathered * esz / 1e6)
            rows.append(row)
            log(f"msda {name:12s} {row['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
            del value, ref, off, attn, got, want
            torch.cuda.empty_cache()
    return rows


def phase_flash(dev, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, Lq, Lk, d, per_tiny, per_base) in FLASH_SHAPES.items():
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
            row = dict(shape=name, dtype=dtype_name(dtype), B=B, Lq=Lq, Lk=Lk, d=d,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            rows.append(row)
            log(f"flash {name:8s} {row['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
    return rows


def phase_dcn(dev, gen):
    """The im2col kernel against its plain version (the kernels line's `ms`,
    `plain_ms`, `bound_ms`), and the whole op (im2col, then the product with
    the weight) against the per-tap plain op."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (N, Cin, H, W, Cout, stride, dg, per_base, per_small) in DCN_SHAPES.items():
            Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
            x = torch.randn(N, Cin, H, W, generator=gen).to(dev, dtype)
            off = torch.randn(N, 2 * dg * 9, Ho, Wo, generator=gen) * 2
            far = torch.rand(off.shape, generator=gen) < 0.02  # well past the borders
            off = torch.where(far, torch.sign(off) * 300.0, off).to(dev, dtype)
            mask = torch.rand(N, dg * 9, Ho, Wo, generator=gen).to(dev, dtype)
            weight = (torch.randn(Cout, Cin, 3, 3, generator=gen) / (Cin * 9) ** 0.5).to(dev)
            geo = dict(stride=stride, padding=1, dilation=1, deform_groups=dg)

            col = dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo)
            col_plain = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo)
            torch.cuda.synchronize()
            err = max_err(col, col_plain, dtype, f"dcn im2col {name} {dtype}")
            col_bytes = col.numel() * col.element_size()
            del col, col_plain
            got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, groups=1, **geo)
            want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, None, groups=1,
                                                         **geo)
            torch.cuda.synchronize()
            op_err = max_err(got, want, dtype, f"dcn op {name} {dtype}")
            del got, want

            esz = x.element_size()
            nbytes = (x.numel() + off.numel() + mask.numel()) * esz + col_bytes
            flops = 8 * N * 9 * Cin * Ho * Wo  # 4 corner weights, 4 multiply-adds per value
            b_ms, b_by = bound(nbytes, flops, dtype)
            gemm_flops = 2 * N * Cout * 9 * Cin * Ho * Wo
            ms = device_ms(lambda: dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo))
            # the same launch with zero offsets (an ordinary im2col): what is
            # left of the time when neighbouring pixels read neighbouring addresses
            zero = torch.zeros_like(off)
            ms_zero = device_ms(lambda: dcn_ops.deform_im2col(x, zero, mask, (3, 3), **geo))
            del zero
            op_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d(
                x, off, mask, weight, None, groups=1, **geo))
            plain_ms = device_ms(lambda: dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo),
                                 n=2, repeats=3)
            op_plain_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d_plain(
                x, off, mask, weight, None, groups=1, **geo), n=2, repeats=3)
            wd = weight.to(dtype)
            lib_ms = device_ms(lambda: F.conv2d(x, wd, None, stride, 1))
            row = dict(shape=name, dtype=dtype_name(dtype), x=[N, Cin, H, W], Cout=Cout,
                       stride=stride, deform_groups=dg,
                       launches_per_frame={"base": per_base, "small": per_small},
                       max_abs_err=err, op_max_abs_err=op_err, ms=ms, ms_zero_offsets=ms_zero,
                       op_ms=op_ms,
                       plain_ms=plain_ms, op_plain_ms=op_plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, op_library_ms=lib_ms, column_mb=col_bytes / 1e6,
                       gemm_gflop=gemm_flops / 1e9,
                       gemm_bound_ms=gemm_flops / PEAK_FLOPS[dtype] * 1e3)
            rows.append(row)
            log(f"dcn {name:9s} {row['dtype']:9s} err im2col {err:.3e} op {op_err:.3e}  "
                f"im2col {ms:.4f} ms (zero offsets {ms_zero:.4f})  op {op_ms:.4f} ms  "
                f"plain im2col {plain_ms:.3f} ms  plain op {op_plain_ms:.3f} ms  "
                f"conv2d {lib_ms:.4f} ms  "
                f"bound {b_ms * 1e3:.2f} us ({b_by}), columns {col_bytes / 1e6:.1f} MB")
            del x, off, mask, weight, wd
            torch.cuda.empty_cache()
    return rows


def gemm_case(M, K, N, gen, dev):
    x = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).to(dev)
    xs = torch.tensor(0.0173, device=dev)
    ws = (torch.rand(N, generator=gen) * 0.02 + 0.001).to(dev)
    return x, w, xs, ws


def phase_int8_gemm(dev, gen, shapes, counts=None, reps=(20, 5)):
    """The int8 product kernel against its plain version (float64 sums, so
    exact) at each (M, K, N) of `shapes`; float32 output must agree bit for
    bit.  `counts` gives launches per frame by shape name."""
    rows = []
    for name, (M, K, N) in shapes.items():
        x, w, xs, ws = gemm_case(M, K, N, gen, dev)
        got = int8_ops.int8_matmul(x, w, xs, ws)
        want = int8_ops.int8_matmul_plain(x, w, xs, ws)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"int8 gemm {name} {(M, K, N)}: max abs err {err}, not exact")
        del want
        nbytes = M * K + N * K + 4 + 4 * N + 4 * M * N
        b_ms, b_by = bound(nbytes, 2 * M * N * K, torch.int8)
        ms = device_ms(lambda: int8_ops.int8_matmul(x, w, xs, ws), *reps)
        plain_ms = device_ms(lambda: int8_ops.int8_matmul_plain(x, w, xs, ws), n=2, repeats=3)
        lib_ms = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:  # what torch._int_mm takes
            wt = w.t()
            lib_ms = device_ms(lambda: torch._int_mm(x, wt), *reps)
        row = dict(shape=name, M=M, K=K, N=N, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   tops=2 * M * N * K / ms / 1e9,
                   launches_per_frame=(counts or {}).get(name, 0))
        rows.append(row)
        log(f"int8 gemm {name:22s} M {M:7d} K {K:5d} N {N:5d}  exact  kernel {ms:.4f} ms "
            f"({row['tops']:.1f} TOP/s)  plain {plain_ms:.4f} ms  _int_mm "
            f"{'%.4f ms' % lib_ms if lib_ms is not None else 'n/a'}  "
            f"bound {b_ms * 1e3:.2f} us ({b_by})")
        del x, w, got
        torch.cuda.empty_cache()
    return rows


def gemm_frame_sums(rows):
    """ms per frame of the int8 product over a frame's launches; the
    library's sum covers only the shapes `torch._int_mm` takes, so the
    kernel's sum over those same launches stands beside it."""
    def tot(key, only=lambda r: True):
        return float(sum(r[key] * r["launches_per_frame"] for r in rows if only(r)))

    lib = lambda r: r["library_ms"] is not None  # noqa: E731
    return {
        "launches_per_frame": sum(r["launches_per_frame"] for r in rows),
        "distinct_shapes": len(rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_by": max(rows, key=lambda r: r["bound_ms"] * r["launches_per_frame"])["bound_by"],
        "library_ms": tot("library_ms", lib), "ms_where_library_runs": tot("ms", lib),
        "launches_where_library_runs": sum(r["launches_per_frame"] for r in rows if lib(r)),
    }


def phase_msda_int8(dev, gen):
    """MSDA from int8 value tables against its plain version.  `ms` is the
    wrapper (three plain passes quantize the value per (batch, head), then
    the kernel); `kernel_ms` the kernel alone on a table made ahead."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (shape, per_tiny, per_base) in MSDA_INT8_SHAPES.items():
            (value, ref, off, attn), shapes = msda_inputs(shape, dtype, gen, dev)
            op = msda_ops.multi_scale_deformable_attn_int8
            got = op(value, ref, off, attn, shapes)
            want = msda_ops.multi_scale_deformable_attn_int8_plain(value, ref, off, attn, shapes)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"msda int8 {name} {dtype}")
            bs, _, nq, P = MSDA_SHAPES[shape][:4]
            H, ch, L, esz = 8, 32, len(shapes), value.element_size()
            small = (off.numel() + attn.numel()) * esz + ref.numel() * 4 + bs * nq * H * ch * esz
            # the function reads the whole floating-point value once (the scale
            # is an amax over it); the kernel alone reads the int8 rows its
            # queries can gather, where they are fewer than the table
            b_ms, b_by = bound(value.numel() * esz + small, bs * nq * H * L * P * 4 * ch * 2, dtype)
            gathered = min(value.numel(), bs * nq * H * L * P * 4 * ch)
            kb_ms, kb_by = bound(gathered + bs * H * 4 + small,
                                 bs * nq * H * L * P * 4 * ch * 2, dtype)
            table = msda_ops.quantize_value_table(value)
            ms = device_ms(lambda: op(value, ref, off, attn, shapes))
            kernel_ms = device_ms(lambda: op(value, ref, off, attn, shapes, table=table))
            float_ms = device_ms(
                lambda: msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes))
            plain_ms = device_ms(lambda: msda_ops.multi_scale_deformable_attn_int8_plain(
                value, ref, off, attn, shapes), n=3, repeats=3)
            row = dict(shape=name, dtype=dtype_name(dtype), bs=bs, nq=nq, levels=shapes, P=P,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       max_abs_err=err, ms=ms, kernel_ms=kernel_ms, float_kernel_ms=float_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       kernel_bound_ms=kb_ms, kernel_bound_by=kb_by,
                       int8_table_mb=value.numel() / 1e6)
            rows.append(row)
            log(f"msda int8 {name:12s} {row['dtype']:9s} err {err:.3e}  wrapper {ms:.4f} ms  "
                f"kernel alone {kernel_ms:.4f} ms (float table {float_ms:.4f})  "
                f"plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by}), "
                f"kernel alone {kb_ms * 1e3:.2f} us")
            del value, ref, off, attn, got, want, table
            torch.cuda.empty_cache()
    return rows


def phase_flash_int8(dev, gen):
    """int8 flash attention against its plain version (the same 256-key
    requantization blocks); `kernel_ms` is the kernel alone on operands
    quantized ahead."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, Lq, Lk, d, per_tiny, per_base) in FLASH_SHAPES.items():
            q = torch.randn(B, Lq, d, generator=gen).to(dev, dtype)
            k = torch.randn(B, Lk, d, generator=gen).to(dev, dtype)
            v = torch.randn(B, Lk, d, generator=gen).to(dev, dtype)
            got = attn_ops.flash_attention_int8(q, k, v)
            want = attn_ops.flash_attention_int8_plain(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if not np.isfinite(err) or err > FLASH_INT8_TOL[dtype] * scale:
                raise AssertionError(f"flash int8 {name} {dtype}: max abs err {err} vs {scale}")
            float_err = float((got.float() - attn_ops.qkv_plain(q, k, v).float()).abs().max())
            esz = q.element_size()
            ops_n = 4 * B * Lq * Lk * d
            b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * esz, ops_n, torch.int8)
            kb_ms, kb_by = bound(q.numel() + k.numel() + v.numel() + 8 + q.numel() * esz, ops_n,
                                 torch.int8)
            operands = attn_ops.int8_operands(q, k, v)
            ms = device_ms(lambda: attn_ops.flash_attention_int8(q, k, v))
            kernel_ms = device_ms(lambda: attn_ops.flash_attention_int8(q, k, v, operands))
            float_ms = device_ms(lambda: attn_ops.flash_attention(q, k, v))
            plain_ms = device_ms(lambda: attn_ops.flash_attention_int8_plain(q, k, v), n=5)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            row = dict(shape=name, dtype=dtype_name(dtype), B=B, Lq=Lq, Lk=Lk, d=d,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       max_abs_err=err, err_vs_float_attention=float_err, ms=ms,
                       kernel_ms=kernel_ms, float_kernel_ms=float_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, kernel_bound_ms=kb_ms,
                       kernel_bound_by=kb_by, library_ms=lib_ms)
            rows.append(row)
            log(f"flash int8 {name:8s} {row['dtype']:9s} err {err:.3e} (vs float attention "
                f"{float_err:.3e})  wrapper {ms:.4f} ms  kernel alone {kernel_ms:.4f} ms "
                f"(float kernel {float_ms:.4f})  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
                f"bound {b_ms * 1e3:.2f} us ({b_by})")
    return rows


COUNT_NAMES = ("msda", "flash_attn", "dcn_im2col", "int8_gemm", "msda_int8", "flash_int8")


def launch_counts():
    return tuple(fn.launches for fn in KERNEL_WRAPPERS)


def record_gemm_shapes(engine, frame):
    """One frame with the int8 product's wrapper logging its (M, K, N):
    the shapes the main path gives it, and how often.  Also counts the
    forward calls of the int8 dense and conv layers."""
    shapes = collections.Counter()
    calls = []
    wrapper = int8_ops.int8_matmul

    def logging(x, w, *a, **kw):
        shapes[(x.shape[0], x.shape[1], w.shape[0])] += 1
        return wrapper(x, w, *a, **kw)

    logging.launches = 0  # the wrapper counts on whatever carries its name

    layers = [m for m in engine.model.modules() if isinstance(m, (QDense, QConv))]
    hooks = [m.register_forward_hook(lambda *a: calls.append(1)) for m in layers
             if m.mode == "int8"]
    int8_ops.int8_matmul = logging
    try:
        engine.reset()
        engine.infer_frame(**frame)
        torch.cuda.synchronize()
    finally:
        int8_ops.int8_matmul = wrapper
        for h in hooks:
            h.remove()
    return shapes, len(calls), sum(m.mode != "int8" for m in layers)


def mean_coords_diff(a, b):
    return max(float((x[2] - y[2]).abs().mean()) for x, y in zip(a, b))


def phase_int8_model(make_cfg, card, dev, gen, exclude, want, calib_frames, methods, n_frames,
                     latency_frames, bf16):
    """One model under quant="int8" at full width: calibrate its QDQ tier on
    the card, attach and fold the scales into the int8 tier of the same
    weights, run frames on the kernel path (launch counts read after each)
    and on the plain path, compare with the QDQ simulation and with floating
    point, take the frame latency, and time the int8 product at every shape
    the frame launched.  `want` = per-frame launches (MSDA, flash, DCN,
    int8-table MSDA, int8 flash); the int8 product's count must equal the
    forward calls of the int8 layers."""
    over = {} if exclude is None else {"quant_exclude": exclude}
    cfg = make_cfg(quant="int8", **over)
    name = f"{cfg.name} int8"
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("scene-A",) * n_frames)
    calib = synthetic_frames(cfg, np.random.default_rng(1), ("calib",) * calib_frames)
    check_rig(cfg, frames)

    t0 = time.perf_counter()
    qdq = BEVFormerEngine(make_cfg(quant=True, quant_exclude=cfg.quant_exclude), seed=0)
    results = {m: qdq.calibrate(calib, method=m) for m in methods}  # the last one stays attached
    result = results[methods[-1]]
    calib_s = time.perf_counter() - t0
    ratio = [results[methods[0]].scales[k] / v for k, v in result.scales.items()]
    log(f"{name}: {len(result.scales)} sites calibrated over {calib_frames} frames with "
        f"{list(methods)} in {calib_s:.1f} s; {methods[-1]} is used "
        f"(median scale ratio {methods[0]}/{methods[-1]} {np.median(ratio):.3f})")
    sim = run_frames(qdq, frames)
    del qdq
    torch.cuda.empty_cache()

    engine = BEVFormerEngine(cfg, seed=0)
    attach_quant_scales(engine.model, result.scales)
    shapes, layer_calls, not_int8 = record_gemm_shapes(engine, frames[0])  # also the warm-up
    if not_int8:
        raise AssertionError(f"{name}: {not_int8} dense or conv layers do not run int8")
    msda, flash, dcn, msda8, flash8 = want
    per_frame_want = (msda, flash, dcn, layer_calls, msda8, flash8)
    reset_launch_counts()
    engine.reset()
    per_frame, outs = [], []
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        outs.append((engine.state.prev_bev.clone(), classes, coords))
        per_frame.append(launch_counts())
    torch.cuda.synchronize()
    launches = dict(zip(COUNT_NAMES, launch_counts()))
    log(f"{name} main path: cumulative launches after each frame {COUNT_NAMES} {per_frame}")
    if per_frame != [tuple(n * i for n in per_frame_want) for i in range(1, n_frames + 1)]:
        raise AssertionError(f"{name}: expected {per_frame_want} launches per frame, "
                             f"got {per_frame}")
    nq, C = cfg.bev_h * cfg.bev_w, cfg.embed_dims
    if tuple(tuple(t.shape) for t in outs[-1]) != ((nq, 1, C), (6, 1, 900, 10), (6, 1, 900, 10)):
        raise AssertionError(f"{name} output shapes")
    dets = NMSFreeCoder().decode(*outs[-1][1:])
    log(f"{name} decode: {len(dets[0]['scores_3d'])} boxes in range of 300")

    image = torch.as_tensor(frames[0]["image"][0], device=dev)
    with torch.inference_mode():
        feats = engine.model.img_neck(engine.model.img_backbone(image))
    plain = run_plain(engine, frames)
    with plain_versions(["int8_gemm"]), torch.inference_mode():  # every other op as it was
        plain_feats = engine.model.img_neck(engine.model.img_backbone(image))
    if not all(torch.equal(a, b) for a, b in zip(feats, plain_feats)):
        raise AssertionError(f"{name}: backbone and neck change when the int8 product runs "
                             "its plain version; the kernel must be exact")
    log(f"{name}: backbone and neck outputs are bit-identical with the int8 product on its "
        "kernel and on its plain version")
    del feats, plain_feats, image
    d_plain, d_sim = mean_coords_diff(outs, plain), mean_coords_diff(outs, sim)
    log(f"{name}: mean |coords - coords'| kernel path vs plain path {d_plain:.4f}, "
        f"int8 vs QDQ simulation {d_sim:.4f} (bar {INT8_COORDS_TOL})")
    err_sim = compare_frames(outs, sim, f"{name} vs QDQ simulation")
    err = compare_frames(outs, plain, f"{name} kernel vs plain", tols=INT8_TOLS)
    del plain, sim

    fp = BEVFormerEngine(make_cfg(), seed=0)
    ref = run_frames(fp, frames)
    del fp
    torch.cuda.empty_cache()
    d_fp = mean_coords_diff(outs, ref)
    err_fp = compare_frames(outs, ref, f"{name} vs float32")
    log(f"{name}: mean |coords - coords'| int8 vs floating point {d_fp:.4f}")
    del ref
    for what, d in (("the plain path", d_plain), ("the QDQ simulation", d_sim)):
        if not d < INT8_COORDS_TOL:
            raise AssertionError(f"{name}: coords stray {d} from {what} (bar "
                                 f"{INT8_COORDS_TOL}; quantization moves them {d_fp})")

    torch.cuda.reset_peak_memory_stats()
    lat = frame_latency(engine, frames, latency_frames)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"{name} f32 activations, frame latency: median {np.median(lat):.3f} ms over "
        f"{len(lat)} frames (min {min(lat):.3f}, max {max(lat):.3f}), peak device memory "
        f"{peak_mb:.0f} MB, on {card}")
    del engine
    torch.cuda.empty_cache()
    res = dict(launches=launches, frames=n_frames, calibration_s=calib_s, sites=len(result.scales),
               int8_layer_calls_per_frame=layer_calls, rel_err_kernel_vs_plain=err,
               rel_err_vs_qdq=err_sim, rel_err_vs_float=err_fp, coords_diff_plain=d_plain,
               coords_diff_qdq=d_sim, coords_diff_float=d_fp,
               latency_ms_median=float(np.median(lat)), latency_ms=lat, peak_memory_mb=peak_mb)
    if bf16:
        engine16 = BEVFormerEngine(make_cfg(quant="int8", dtype="bfloat16", **over), seed=0)
        attach_quant_scales(engine16.model, result.scales)
        got16 = run_frames(engine16, frames)
        res["coords_diff_bf16_vs_f32_activations"] = mean_coords_diff(got16, outs)
        lat16 = frame_latency(engine16, frames, latency_frames)
        log(f"{name} bf16 activations, frame latency: median {np.median(lat16):.3f} ms over "
            f"{len(lat16)} frames; mean |coords - coords'| vs f32 activations "
            f"{res['coords_diff_bf16_vs_f32_activations']:.4f}, on {card}")
        res.update(latency_ms_median_bf16=float(np.median(lat16)), latency_ms_bf16=lat16)
        del engine16, got16
        torch.cuda.empty_cache()
    del outs

    named = {f"{M}x{K}x{N}": (M, K, N) for (M, K, N) in sorted(shapes)}
    counts = {f"{M}x{K}x{N}": c for (M, K, N), c in shapes.items()}
    res["gemm_shapes"] = phase_int8_gemm(dev, gen, named, counts, reps=(5, 3))
    return res


def run_plain(engine, frames):
    """The same frames with the kernel wrappers swapped for their plain
    versions (the port itself never sends a CUDA tensor to them)."""
    with plain_versions():
        return run_frames(engine, frames)


def compare_frames(got, want, what, max_tol=None, rms_tol=None, tols=None, first_layer_tol=None):
    """Worst relative errors over the frames' bev_embed, classes and coords:
    "max" = max |a - b| / max |b| and "rms" = ||a - b|| / ||b||.  Fails
    above a given tolerance (`tols` gives them per output and overrides
    `max_tol` and `rms_tol`; `first_layer_tol` holds the first decoder
    layer's classes and coords in the max norm) or on non-finite values."""
    worst = {"max": 0.0, "rms": 0.0, "first_layer_max": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("bev_embed", "classes", "coords"), g, w):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{what} frame {i} {name}: non-finite values")
            r = rel_errors(a, b)
            log(f"  {what} frame {i} {name:9s} rel err max {r['max']:.3e} rms {r['rms']:.3e}")
            bars = tols[name] if tols else {"max": max_tol, "rms": rms_tol}
            for key in ("max", "rms"):
                tol = bars.get(key)
                if tol is not None and not r[key] <= tol:
                    raise AssertionError(f"{what} frame {i} {name}: {key} rel err {r[key]} > {tol}")
                worst[key] = max(worst[key], r[key])
            if name != "bev_embed":
                first = rel_errors(a[0], b[0])["max"]
                worst["first_layer_max"] = max(worst["first_layer_max"], first)
                if first_layer_tol is not None and not first <= first_layer_tol:
                    raise AssertionError(f"{what} frame {i} {name}: first decoder layer max "
                                         f"rel err {first} > {first_layer_tol}")
    return worst


def frame_latency(engine, frames, n):
    """Host-clock ms of `n` temporal frames, each ending in a synchronise,
    after one warm-up frame."""
    bench = [dict(f, scene_token="scene-A") for f in (frames * (n // len(frames) + 2))[:n + 1]]
    lat = []
    engine.reset()
    for i, f in enumerate(bench):
        t0 = time.perf_counter()
        engine.infer_frame(**f)
        torch.cuda.synchronize()
        if i >= 1:
            lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def check_rig(cfg, frames):
    visible, overflow = cam_budget_overflow(cfg, frames[0]["lidar2img"])
    log(f"{cfg.name} rig: visible BEV queries per camera {visible.tolist()}, overflow {overflow}")
    if (visible == 0).any() or overflow > 0:
        raise AssertionError(
            f"{cfg.name}: the rig must show every camera some BEV queries within K")


def phase_model(make_cfg, card, per_frame_want, latency_frames, f32_tols=None):
    """One model at full width: three frames on the kernel path with the
    launch counts read after each, the decode, the same frames on the plain
    path, the frame latency, and one bfloat16 pass."""
    cfg = make_cfg()
    name = cfg.name
    rng = np.random.default_rng(0)
    frames = synthetic_frames(cfg, rng, ("scene-A", "scene-A", "scene-B"))
    check_rig(cfg, frames)
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
        per_frame.append(launch_counts())
    torch.cuda.synchronize()
    launches = dict(zip(COUNT_NAMES, launch_counts()))
    log(f"{name} main path: cumulative launches after each frame {COUNT_NAMES} {per_frame}")
    per_frame_want = tuple(per_frame_want) + (0, 0, 0)  # no int8 kernel on this path
    if per_frame != [tuple(n * i for n in per_frame_want) for i in (1, 2, 3)]:
        raise AssertionError(f"{name}: expected {per_frame_want} launches per frame, "
                             f"got {per_frame}")

    shapes = tuple(tuple(t.shape) for t in outs[-1])
    if shapes != ((nq, 1, C), (6, 1, 900, 10), (6, 1, 900, 10)):
        raise AssertionError(f"{name} output shapes {shapes}")
    classes, coords = outs[-1][1:]
    dets = NMSFreeCoder().decode(classes, coords)
    log(f"{name} decode: {len(dets[0]['scores_3d'])} boxes in range of 300")

    plain = run_plain(engine, frames)
    err32 = compare_frames(outs, plain, f"{name} f32 kernel vs plain", max_tol=F32_MAX_TOL,
                           tols=f32_tols, first_layer_tol=F32_MAX_TOL)
    log(f"{name} f32 kernel vs plain: worst max {err32['max']:.3e}, rms {err32['rms']:.3e}, "
        f"first decoder layer max {err32['first_layer_max']:.3e}")

    torch.cuda.reset_peak_memory_stats()
    lat = frame_latency(engine, frames, latency_frames)
    latency = float(np.median(lat))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"{name} f32 frame latency: median {latency:.3f} ms over {len(lat)} frames "
        f"(min {min(lat):.3f}, max {max(lat):.3f}), peak device memory {peak_mb:.0f} MB, on {card}")
    del engine
    torch.cuda.empty_cache()

    # bfloat16, same weights: in bfloat16 one-ulp rounding differences grow
    # through the layers and the random-weight decoder amplifies the worst
    # elements (max rel err 0.05-0.13 between the two paths), so bfloat16 is
    # held in the rms norm: the kernel path agrees with the plain path, and
    # strays from the float32 result no further than the plain path does
    engine16 = BEVFormerEngine(make_cfg(dtype="bfloat16"), seed=0)
    got16 = run_frames(engine16, frames)
    plain16 = run_plain(engine16, frames)
    lat16 = frame_latency(engine16, frames, latency_frames)
    latency16 = float(np.median(lat16))
    err16 = compare_frames(got16, plain16, f"{name} bf16 kernel vs plain", rms_tol=BF16_RMS_TOL)
    drift_k = compare_frames(got16, plain, f"{name} bf16 kernel vs f32 plain")["rms"]
    drift_p = compare_frames(plain16, plain, f"{name} bf16 plain vs f32 plain")["rms"]
    if not drift_k <= 1.5 * drift_p + 1e-3:
        raise AssertionError(
            f"{name}: bf16 kernel path drifts {drift_k} from float32, plain path {drift_p}")
    log(f"{name} bf16 frame latency: median {latency16:.3f} ms over {len(lat16)} frames "
        f"(min {min(lat16):.3f}, max {max(lat16):.3f}) on {card}")
    del engine16
    torch.cuda.empty_cache()
    return dict(launches=launches, frames=len(frames), rel_err_f32=err32, rel_err_bf16=err16,
                bf16_drift_kernel=drift_k, bf16_drift_plain=drift_p,
                latency_ms_median=latency, latency_ms=lat, latency_ms_median_bf16=latency16,
                latency_ms_bf16=lat16,
                peak_memory_mb=peak_mb)


def phase_small(card):
    """One BEVFormer-small frame at full width on the kernel path."""
    cfg = bevformer_small()
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("scene-A",))
    check_rig(cfg, frames)
    engine = BEVFormerEngine(cfg, seed=0)
    run_frames(engine, frames)  # warm-up
    reset_launch_counts()
    t0 = time.perf_counter()
    (bev, classes, coords), = run_frames(engine, frames)
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"small main path: launches (msda, flash, dcn) {counts}; frame {ms:.3f} ms on {card}")
    if counts != (12, 6, 26, 0, 0, 0):
        raise AssertionError(f"small: expected (12, 6, 26, 0, 0, 0) launches per frame, "
                             f"got {counts}")
    shapes = tuple(tuple(t.shape) for t in (bev, classes, coords))
    if shapes != ((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), (6, 1, 900, 10), (6, 1, 900, 10)):
        raise AssertionError(f"small output shapes {shapes}")
    for what, t in (("bev_embed", bev), ("classes", classes), ("coords", coords)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"small {what}: non-finite values")
    return dict(launches=dict(zip(COUNT_NAMES, counts)), frame_ms=ms)


def frame_sums(rows, frame, library, extra=()):
    """The float32 launches of one `frame` (tiny, base) at the main path's
    shapes, summed: ms per frame.  `extra` names further row keys to sum."""
    main = [r for r in rows if r["dtype"] == "float32" and r["launches_per_frame"].get(frame)]

    def tot(key):
        return float(sum(r[key] * r["launches_per_frame"][frame] for r in main))

    return {
        "launches_per_frame": sum(r["launches_per_frame"][frame] for r in main),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_us": tot("bound_ms") * 1e3,
        "bound_by": max(main, key=lambda r: r["bound_ms"] * r["launches_per_frame"][frame])[
            "bound_by"],
        "library_ms": tot("library_ms") if library else None,
        **{key: tot(key) for key in extra},
    }


def kernel_entry(name, source, replaces, rows, library, frame, launches, also=None, extra=(),
                 note=""):
    """One entry of the kernels line.  Its numbers are sums over one
    `frame`'s float32 launches; `launches` is the count of that model's
    main-path run.  `also` = (frame, launches) adds another model's sums and
    count under keys prefixed with its name; `extra` row keys are summed
    too and `note` is appended to the entry's `per`."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, **frame_sums(rows, frame, library, extra),
             "per": f"one {frame} frame: the sum over its float32 launches at the main "
                    f"path's shapes{note}"}
    if also:
        other, count = also
        entry[f"{other}_launches"] = count
        entry.update({f"{other}_{k}": v for k, v in frame_sums(rows, other, library).items()})
    entry["shapes"] = rows
    return entry


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

    t_start = time.perf_counter()
    build_logs = _cuda.build(verbose=True)
    build_s = time.perf_counter() - t_start
    log(f"kernels built in {build_s:.2f} s: {sorted(build_logs)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    res = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s)
    seconds = {}
    for phase, fn in (
            ("msda", lambda: phase_msda(dev, gen)),
            ("flash", lambda: phase_flash(dev, gen)),
            ("dcn", lambda: phase_dcn(dev, gen)),
            ("tiny", lambda: phase_model(bevformer_tiny, card, (12, 6, 0), latency_frames=6)),
            ("base", lambda: phase_model(bevformer_base, card, (18, 6, 26), latency_frames=6,
                                         f32_tols=BASE_F32_TOL)),
            ("small", lambda: phase_small(card)),
            ("int8_gemm", lambda: phase_int8_gemm(dev, gen, GEMM_SHAPES)),
            ("msda_int8", lambda: phase_msda_int8(dev, gen)),
            ("flash_int8", lambda: phase_flash_int8(dev, gen)),
            ("tiny_int8", lambda: phase_int8_model(
                bevformer_tiny, card, dev, gen, exclude=None, want=(3, 0, 0, 9, 6),
                calib_frames=4, methods=("max", "entropy"), n_frames=3, latency_frames=6,
                bf16=True)),
            ("base_int8", lambda: phase_int8_model(
                bevformer_base, card, dev, gen, exclude=("self_attn/msda_tables", "dcn_tables"),
                want=(6, 0, 26, 12, 6), calib_frames=2, methods=("max",), n_frames=2,
                latency_frames=3, bf16=False))):
        t0 = time.perf_counter()
        res[phase] = fn()
        seconds[phase] = time.perf_counter() - t0
        log(f"phase {phase} took {seconds[phase]:.1f} s")
    res["phase_seconds"] = seconds

    tiny, base = res["tiny"]["launches"], res["base"]["launches"]
    kernels = [
        kernel_entry("msda", "bevformer_tensorrt_tpu_torch/csrc/msda.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247",
                     res["msda"], False, "tiny", tiny["msda"], also=("base", base["msda"])),
        kernel_entry("flash_attn", "bevformer_tensorrt_tpu_torch/csrc/flash_attn.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/flash_attn.py:183",
                     res["flash"], True, "tiny", tiny["flash_attn"],
                     also=("base", base["flash_attn"])),
        kernel_entry("dcn_im2col", "bevformer_tensorrt_tpu_torch/csrc/dcn.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247",
                     res["dcn"], False, "base", base["dcn_im2col"],
                     extra=("op_ms", "op_plain_ms", "op_library_ms"),
                     note="; no library call computes a deformable im2col, so library_ms is "
                          "null; op_ms is the whole op (im2col, then the product with the "
                          "weight) and op_library_ms cuDNN's ordinary F.conv2d of the same "
                          "shape, a yardstick for the op only"),
    ]
    tiny8, base8 = res["tiny_int8"], res["base_int8"]
    gemm = {"name": "int8_gemm", "route": "cuda",
            "source": "bevformer_tensorrt_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "bevformer_tensorrt_tpu/ops/pallas/int8_matmul.py:41",
            "launches": tiny8["launches"]["int8_gemm"], **gemm_frame_sums(tiny8["gemm_shapes"]),
            "per": "one tiny int8 frame: the sum over its launches, each timed at its own "
                   "(M, K, N) as recorded on the main path; library_ms is torch._int_mm "
                   "(int32 sums without the dequantization) over the launches whose shape it "
                   "takes, ms_where_library_runs the kernel over the same launches",
            "base_launches": base8["launches"]["int8_gemm"],
            **{f"base_{k}": v for k, v in gemm_frame_sums(base8["gemm_shapes"]).items()},
            "shapes": res["int8_gemm"] + tiny8["gemm_shapes"] + base8["gemm_shapes"]}
    quantize_note = ("; ms is the wrapper, which quantizes its floating-point inputs with plain "
                     "passes before the launch, kernel_ms the kernel alone, float_kernel_ms the "
                     "floating-point kernel at the same shape")
    extra = ("kernel_ms", "float_kernel_ms", "kernel_bound_ms")
    kernels += [
        gemm,
        kernel_entry("msda_int8", "bevformer_tensorrt_tpu_torch/csrc/msda.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247 (packed='int8': "
                     "bevformer_tensorrt_tpu/ops/msda.py:330)",
                     res["msda_int8"], False, "tiny", tiny8["launches"]["msda_int8"],
                     also=("base", base8["launches"]["msda_int8"]), extra=extra,
                     note=quantize_note),
        kernel_entry("flash_int8", "bevformer_tensorrt_tpu_torch/csrc/flash_attn_int8.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/flash_attn.py:118",
                     res["flash_int8"], True, "tiny", tiny8["launches"]["flash_int8"],
                     also=("base", base8["launches"]["flash_int8"]), extra=extra,
                     note=quantize_note),
    ]
    for k in kernels:
        if k["launches"] < 1 or k.get("base_launches", 1) < 1:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    res["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    summary = [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]
    log(json.dumps({"kernels": summary}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
