#!/usr/bin/env python3
"""Drive the PyTorch port of BEVFormer on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero before the result lines):
  0. Print the card, torch and CUDA versions; build every kernel of the
     port with nvcc (sm_90a), all sources at once; TF32 off.
  1. MSDA kernel vs its plain version on the card, at the shapes of the
     main paths of BEVFormer-tiny and BEVFormer-base (temporal
     self-attention, spatial cross-attention, decoder cross-attention) and
     at the edges of its launch geometry (ch 16 and 64, 64 taps a head, 320
     taps a head in two passes, ch 256 in two chunks, 64 heads x 256 taps
     in four passes), float32 and bfloat16, with samples past every border.
  2. Flash-attention kernel vs its plain version: (8, 900, 32), a ragged
     length, head dims 64 and 8, float32 and bfloat16, and at the decoder
     shape the heads read where they lie (`multi_head_attention`, one
     device kernel a call, counted with torch.profiler);
     `scaled_dot_product_attention` is timed beside it as a yardstick,
     with the bound (bytes, products, exponentials) and TFLOP/s.
  3. DCNv2: the whole op vs its plain version, NCHW and NHWC, at the
     stage-3 and stage-4 shapes of base and small, one shape with stride 2,
     two deform groups and a ragged size, and one with two groups, float32
     (the im2col route) and bfloat16 (the fused kernel and its gather
     table, bit for bit the map with its channels last); the deformable
     im2col kernel vs its plain version; offsets past every border; the op
     timed beside the parent's route (im2col kernel, then the product),
     cuDNN's ordinary `F.conv2d` of the same shape and the op's bound (the
     op as the model calls it, its weight matrix kept); the fused kernel
     alone in each tile configuration; for float32 also the fused FFMA
     kernel on the map with its table, which the dtype rule of ops/dcn.py
     weighs against the route.
  4. BEVFormer-tiny at full width through `BEVFormerEngine`, seeded weights,
     6 random images on a 6-camera rig: three frames (new scene, temporal,
     scene change) with the launch counts set to 0 just before and read
     just after; then the same frames through the plain versions on the
     card, which must agree; the frame latency; one bfloat16 pass.
  5. BEVFormer-base at full width (R101 with DCN, four levels, 200x200 BEV),
     the same way: exactly 18 MSDA, 6 flash and 26 DCN launches per frame
     (float32: 26 im2col; bfloat16: 26 fused, 26 gather tables, no im2col),
     peak device memory.
  6. One BEVFormer-small frame at full width in float32 and one in
     bfloat16: 12 / 6 / 26 launches, as at base.
  7. The int8 product kernel vs its plain version (bit for bit) at named
     shapes of the quantized path: dense layers, a 1x1 and a 3x3 convolution
     with K = 4608 as matrices, the odd shapes K = 18, K = 147, N = 3, and
     the edges of the tile configurations (M = 1, N = 8 at K = 16, K = 32,
     one row past a tile multiple); each row names its tile configuration;
     `torch._int_mm` is timed beside it as a yardstick where it takes the
     shape.
  8. MSDA from int8 value tables vs its plain version at the SCA and decoder
     shapes of tiny and base and the edge shapes of phase 1, the kernel
     alone and with the quantization.
  9. int8 flash attention vs its plain version at (8, 900, 32), a ragged
     length and head dim 64, and the heads where they lie; the codes and
     scales of its amax and quantize launches bit for bit `int8_operands`';
     the op, the attention kernel alone and the quantization alone timed,
     and the device kernels of one call counted (at most three).
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
 11. BEVFormer-base under quant="int8", default policy (only TSA's tables
     stay floating point), the same way with fewer frames: 12 int8-table and
     6 floating-point MSDA, 6 int8 flash, 26 int8-table DCN (fused kernel
     and gather table) and no floating-point DCN or im2col launches per
     frame.  Then one frame with `dcn_tables` excluded as well (26
     floating-point DCN launches, no int8-table ones), and one
     BEVFormer-small frame under the default policy (3 + 9 MSDA, 6 int8
     flash, 26 int8-table DCN); peak device memory.
 12. One JSON line of per-kernel numbers, the nvidia-smi line of the card,
     and the final `{"ok": true, "device": ...}` line.
Ahead of phase 10, three phases of their own:
  a. The DCN op from the int8 table (the fused kernel, float32 and
     bfloat16 activations) vs its plain version, NCHW and NHWC, at the
     stage-3 and stage-4 shapes of base and small and one shape with stride
     2, channel groups of 32 and a ragged size, offsets past every border;
     the gather table's int8 codes bit for bit `quantize_dcn_table`'s; the
     int8 im2col kernel (the old route) vs its plain version; the op (its
     weight matrix kept, as the model keeps it) timed beside the parent's
     route (the table by plain passes, the int8 im2col, the product), the
     table kernel and the im2col kernel alone.
  b. The gather probes (`gather_rows`, `gather_blend`) vs their plain
     versions at the base and tiny cross-attention shapes for float32,
     bfloat16 and int8 rows, `torch.gather` timed beside the row gather and
     `F.embedding_bag` with per-sample weights beside the blend; the MSDA
     kernel's own indices replayed through `gather_blend`; then the
     kernel bench tool, driven through its `main`, with the launch counts
     set to 0 before and read after.
  c. One tiny frame from an engine built through
     `load_bevformer_checkpoint` out of a seeded upstream-layout state_dict,
     bit for bit equal to the engine holding the same tensors directly.

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
from bevformer_tensorrt_tpu_torch.ops import gather_probe as probe_ops
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    load_bevformer_checkpoint,
    upstream_layout,
)
from bevformer_tensorrt_tpu_torch.tools import kernel_bench
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc
from bevformer_tensorrt_tpu_torch.tools.kernel_cases import (
    DCN_INT8_SHAPES,
    DCN_SHAPES,
    FLASH_SHAPES,
    GEMM_SHAPES,
    MSDA_EDGE_SHAPES,
    MSDA_INT8_SHAPES,
    MSDA_SHAPES,
    PEAK_FLOPS,
    PROBE_SHAPES,
    bound,
    device_ms,
    dtype_name,
    gemm_case,
)
from bevformer_tensorrt_tpu_torch.tools.path_diff import plain_versions, rel_errors, run_frames

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


def max_err(got, want, dtype, what):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not np.isfinite(err) or err > TOL[dtype] * max(scale, 1e-12):
        raise AssertionError(f"{what}: max abs err {err} vs max |plain| {scale}")
    return err


MSDA_CASES = ([(name, spec[:5], 32, 8, spec[5], spec[6]) for name, spec in MSDA_SHAPES.items()]
              + [(name, spec[:5], spec[5], spec[6], 0, 0)
                 for name, spec in MSDA_EDGE_SHAPES.items()])


def msda_geometry(value, table, ref, attn, shapes):
    bs, _, heads, ch = value.shape
    L = len(shapes)
    return msda_ops.msda_launch_geometry(bs, ref.shape[1], heads, ch, L, attn.shape[-1] // L,
                                         table.element_size(), table.data_ptr())


def phase_msda(dev, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec, ch, heads, per_tiny, per_base in MSDA_CASES:
            (value, ref, off, attn), shapes = kc.msda_inputs(spec, dtype, gen, dev, heads=heads,
                                                             ch=ch)
            got = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes)
            want = msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"msda {name} {dtype}")
            bs, _, nq, P = spec[:4]
            esz = value.element_size()
            nbytes, flops, gathered = kc.msda_work(value, ref, off, attn, shapes)
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms = device_ms(lambda: msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes))
            plain_ms = device_ms(
                lambda: msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes),
                n=3, repeats=3)
            row = dict(shape=name, dtype=dtype_name(dtype), bs=bs, nq=nq, levels=shapes,
                       P=P, ch=ch, heads=heads,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       geometry=msda_geometry(value, value, ref, attn, shapes),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       value_table_mb=value.numel() * esz / 1e6, gathered_mb=gathered * esz / 1e6)
            rows.append(row)
            log(f"msda {name:12s} {row['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
            del value, ref, off, attn, got, want
            torch.cuda.empty_cache()
    return rows


def launch_count(kernels):
    return "not measured (the profiler saw nothing)" if kernels is None else len(kernels)


def phase_flash(dev, gen):
    """Flash attention against its plain version at each shape, [B, L, d];
    at the decoder shape also the B problems as the heads of one sequence
    through `multi_head_attention`, which the kernel reads where they lie,
    with the device kernels one such call launches (torch.profiler: no copy
    splits or merges the heads).  SDPA is timed beside it; the bound is the
    larger of the bytes, the products (bfloat16 on the tensor cores, float32
    as split TF32: three TF32 products) and the exponentials."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, Lq, Lk, d, per_tiny, per_base) in FLASH_SHAPES.items():
            q, k, v = kc.flash_inputs((B, Lq, Lk, d), dtype, gen, dev)
            got = attn_ops.flash_attention(q, k, v)
            want = attn_ops.qkv_plain(q, k, v)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"flash {name} {dtype}")
            nbytes, flops, exps = kc.flash_work(q, k, v)
            b_ms, b_by = bound(nbytes, flops, kc.flash_peak(dtype), exps)
            ms = device_ms(lambda: attn_ops.flash_attention(q, k, v))
            plain_ms = device_ms(lambda: attn_ops.qkv_plain(q, k, v), n=5)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            row = dict(shape=name, dtype=dtype_name(dtype), B=B, Lq=Lq, Lk=Lk, d=d,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       geometry=attn_ops.flash_launch_geometry(B, Lq, Lk, d, dtype_name(dtype)),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, tflops=flops / ms / 1e9,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            if name == "decoder":
                qh, kh, vh = (kc.heads_layout(t) for t in (q, k, v))
                goth = attn_ops.multi_head_attention(qh, kh, vh, B)
                torch.cuda.synchronize()
                row["heads_max_abs_err"] = max_err(goth, kc.heads_layout(want), dtype,
                                                   f"flash {name} {dtype}, heads where they lie")
                row["heads_ms"] = device_ms(lambda: attn_ops.multi_head_attention(qh, kh, vh, B))
                row["device_kernels"] = kc.device_kernels(
                    lambda: attn_ops.multi_head_attention(qh, kh, vh, B))
                # the int8 op's, counted here too, before the later phases
                row["int8_device_kernels"] = kc.device_kernels(
                    lambda: attn_ops.multi_head_attention(qh, kh, vh, B, int8=True))
                for key, most in (("device_kernels", 1), ("int8_device_kernels", 3)):
                    if row[key] is not None and len(row[key]) > most:
                        raise AssertionError(f"flash: one call launched {row[key]}")
            rows.append(row)
            log(f"flash {name:8s} {row['dtype']:9s} err {err:.3e}  kernel {ms * 1e3:.2f} us "
                f"({row['tflops']:.1f} TFLOP/s)  sdpa {lib_ms * 1e3:.2f} us  plain {plain_ms:.4f} ms"
                f"  bound {b_ms * 1e3:.2f} us ({b_by})"
                + (f"  heads where they lie {row['heads_ms'] * 1e3:.2f} us, device kernels a "
                   f"call {launch_count(row['device_kernels'])} (int8 op "
                   f"{launch_count(row['int8_device_kernels'])})" if "heads_ms" in row else ""))
    return rows


def dcn_route_ms(x, off, mask, weight, geo, groups, table=None):
    """The parent's route for the whole op, timed: the deformable im2col
    kernel (from the float map, or from an int8 table made ahead), then the
    product with the weight (`col_product`)."""
    Ho, Wo = off.shape[1:3] if geo["layout"] == "NHWC" else off.shape[2:]
    if table is None:
        return device_ms(lambda: dcn_ops.col_product(
            dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo), weight, None, Ho, Wo,
            geo["layout"], groups))
    return device_ms(lambda: dcn_ops.col_product(
        dcn_ops.deform_im2col_int8(*table, off, mask, (3, 3), **geo), weight.to(off.dtype),
        None, Ho, Wo, geo["layout"], groups))


def phase_dcn(dev, gen):
    """The whole op against its plain version, NCHW and NHWC: bfloat16 on the
    fused kernel, float32 on the im2col route (the dtype rule of ops/dcn.py);
    the fused kernel timed beside the parent's route (im2col kernel, then the
    product), cuDNN's ordinary `F.conv2d` of the same shape and the op's
    bound; the gather table kernel against its plain version (bit for bit);
    the im2col kernel against its plain version (the kernels line's
    `dcn_im2col` entry)."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in DCN_SHAPES.items():
            N, Cin, H, W, Cout, stride, dg, per_base, per_small, groups = spec
            Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
            errs = {}
            for layout in ("NHWC", "NCHW"):  # the timings below use the model's NCHW
                x, off, mask, weight, geo = kc.dcn_inputs(spec, dtype, gen, dev, layout)
                got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, groups=groups,
                                                      **geo)
                want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, None,
                                                             groups=groups, **geo)
                torch.cuda.synchronize()
                errs[layout] = max_err(got, want, dtype, f"dcn op {name} {layout} {dtype}")
                del got, want
            table, _ = dcn_ops.dcn_gather_table(x)
            if not torch.equal(table, dcn_ops.dcn_gather_table_plain(x)[0]):
                raise AssertionError(f"dcn gather table {name} {dtype}: not the map, channels last")
            del table
            col = dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo)
            col_plain = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo)
            torch.cuda.synchronize()
            err = max_err(col, col_plain, dtype, f"dcn im2col {name} {dtype}")
            del col, col_plain

            nbytes, flops, col_bytes = kc.dcn_work(spec, x.element_size())
            b_ms, b_by = bound(nbytes, flops, dtype)
            op_b_ms, op_b_by = bound(*kc.dcn_op_work(spec, x.element_size()), dtype)
            t_b_ms, t_b_by = bound(2 * x.numel() * x.element_size(), 0, dtype)
            gemm_flops = 2 * N * Cout * 9 * (Cin // groups) * Ho * Wo
            ms = device_ms(lambda: dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo))
            # the op as the model calls it: the weight matrix kept (DeformConv2d)
            wmat = dcn_ops.dcn_weight_matrix(weight, dtype) if dtype == torch.bfloat16 else None
            op_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d(
                x, off, mask, weight, None, groups=groups, wmat=wmat, **geo))
            table_ms = table_plain_ms = None
            if dtype == torch.bfloat16:  # the op itself; for float32 the route below
                fused_ms = op_ms
                table_ms = device_ms(lambda: dcn_ops.dcn_gather_table(x))
                table_plain_ms = device_ms(lambda: dcn_ops.dcn_gather_table_plain(x))
            else:  # the fused FFMA kernel on the float map, its table included: what the
                # dtype rule weighs against the route
                def fused_float():
                    dcn_ops.fused_launcher(x, off, mask, weight, None, stride, 1, 1, groups, dg,
                                           "NCHW", False)[1]()
                fused_ms = device_ms(fused_float)
            route_ms = dcn_route_ms(x, off, mask, weight, geo, groups)
            _, launch = dcn_ops.fused_launcher(x, off, mask, weight, None, stride, 1, 1, groups,
                                               dg, "NCHW", False)
            config_ms = {c: device_ms(lambda: launch(c))  # the kernel alone, table made ahead
                         for c, v in dcn_ops.DCN_CONFIGS.items() if v[0] == dtype}
            plain_ms = device_ms(lambda: dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo),
                                 n=2, repeats=3)
            op_plain_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d_plain(
                x, off, mask, weight, None, groups=groups, **geo), n=2, repeats=3)
            wd = weight.to(dtype)
            lib_ms = device_ms(lambda: F.conv2d(x, wd, None, stride, 1, 1, groups))
            row = dict(shape=name, dtype=dtype_name(dtype), x=[N, Cin, H, W], Cout=Cout,
                       stride=stride, deform_groups=dg, groups=groups,
                       launches_per_frame={"base": per_base, "small": per_small},
                       max_abs_err=err, op_max_abs_err=errs["NCHW"],
                       op_max_abs_err_nhwc=errs["NHWC"], ms=ms, op_ms=op_ms,
                       fused_ms=fused_ms, config_ms=config_ms, table_ms=table_ms,
                       table_plain_ms=table_plain_ms,
                       table_bound_by="bytes", table_max_abs_err=0.0, route_ms=route_ms,
                       plain_ms=plain_ms, op_plain_ms=op_plain_ms, bound_ms=b_ms, bound_by=b_by,
                       op_bound_ms=op_b_ms, op_bound_by=op_b_by,
                       table_bound_ms=t_b_ms if dtype == torch.bfloat16 else None,
                       library_ms=None, op_library_ms=lib_ms, column_mb=col_bytes / 1e6,
                       gemm_gflop=gemm_flops / 1e9, op_tflops=gemm_flops / op_ms / 1e9)
            rows.append(row)
            log(f"dcn {name:9s} {row['dtype']:9s} err op NCHW {errs['NCHW']:.3e} NHWC "
                f"{errs['NHWC']:.3e} im2col {err:.3e}  op {op_ms:.4f} ms "
                f"({row['op_tflops']:.1f} TFLOP/s; bound {op_b_ms * 1e3:.1f} us, {op_b_by})  "
                f"fused {fused_ms:.4f} ms (by tile {json.dumps(config_ms)})  parent route "
                f"{route_ms:.4f} ms  conv2d {lib_ms:.4f} ms  "
                + (f"table {table_ms:.4f} ms  " if table_ms is not None else "")
                + f"im2col {ms:.4f} ms (bound {b_ms * 1e3:.2f} us)  plain op {op_plain_ms:.3f} ms")
            del x, off, mask, weight, wd
            torch.cuda.empty_cache()
    return rows


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
        b_ms, b_by = bound(*kc.gemm_work(M, K, N), torch.int8)
        ms = device_ms(lambda: int8_ops.int8_matmul(x, w, xs, ws), *reps)
        plain_ms = device_ms(lambda: int8_ops.int8_matmul_plain(x, w, xs, ws), n=2, repeats=3)
        lib_ms = None
        if kc.int_mm_takes(M, K, N):
            wt = w.t()
            lib_ms = device_ms(lambda: torch._int_mm(x, wt), *reps)
        config = int8_ops.gemm_config(M, N, K + (-K) % int8_ops.K_ALIGN)
        row = dict(shape=name, M=M, K=K, N=N, config=config, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   tops=2 * M * N * K / ms / 1e9,
                   launches_per_frame=(counts or {}).get(name, 0))
        rows.append(row)
        log(f"int8 gemm {name:22s} M {M:7d} K {K:5d} N {N:5d} {config:7s} exact  "
            f"kernel {ms:.4f} ms "
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
    cases = ([(name, MSDA_SHAPES[shape][:5], 32, 8, per_tiny, per_base)
              for name, (shape, per_tiny, per_base) in MSDA_INT8_SHAPES.items()]
             + [(name, spec[:5], spec[5], spec[6], 0, 0)
                for name, spec in MSDA_EDGE_SHAPES.items()])
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec, ch, heads, per_tiny, per_base in cases:
            (value, ref, off, attn), shapes = kc.msda_inputs(spec, dtype, gen, dev, heads=heads,
                                                             ch=ch)
            op = msda_ops.multi_scale_deformable_attn_int8
            got = op(value, ref, off, attn, shapes)
            want = msda_ops.multi_scale_deformable_attn_int8_plain(value, ref, off, attn, shapes)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype, f"msda int8 {name} {dtype}")
            bs, _, nq, P = spec[:4]
            whole, alone = kc.msda_int8_work(value, ref, off, attn, shapes)
            b_ms, b_by = bound(*whole, dtype)
            kb_ms, kb_by = bound(*alone, dtype)
            table = msda_ops.quantize_value_table(value)
            ms = device_ms(lambda: op(value, ref, off, attn, shapes))
            kernel_ms = device_ms(lambda: op(value, ref, off, attn, shapes, table=table))
            float_ms = device_ms(
                lambda: msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes))
            plain_ms = device_ms(lambda: msda_ops.multi_scale_deformable_attn_int8_plain(
                value, ref, off, attn, shapes), n=3, repeats=3)
            row = dict(shape=name, dtype=dtype_name(dtype), bs=bs, nq=nq, levels=shapes, P=P,
                       ch=ch, heads=heads, launches_per_frame={"tiny": per_tiny, "base": per_base},
                       geometry=msda_geometry(value, table[0], ref, attn, shapes),
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
    requantization blocks), [B, L, d] and, at the decoder shape, the heads
    where they lie; its amax and quantize launches' codes and scales bit for
    bit `int8_operands`'.  `ms` is the whole op (three launches), `kernel_ms`
    the attention kernel alone on operands quantized ahead (`operands=`),
    `quantize_ms` the amax and quantize launches alone; the device kernels
    one decoder call launches are counted with torch.profiler (at most
    three)."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, Lq, Lk, d, per_tiny, per_base) in FLASH_SHAPES.items():
            if d not in attn_ops.INT8_FLASH_HEAD_DIMS:
                continue
            q, k, v = kc.flash_inputs((B, Lq, Lk, d), dtype, gen, dev)
            got = attn_ops.flash_attention_int8(q, k, v)
            want = attn_ops.flash_attention_int8_plain(q, k, v)
            operands = attn_ops.int8_operands(q, k, v)
            codes = attn_ops.flash_int8_quantize(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if not np.isfinite(err) or err > FLASH_INT8_TOL[dtype] * scale:
                raise AssertionError(f"flash int8 {name} {dtype}: max abs err {err} vs {scale}")
            if not all(torch.equal(a, b) for a, b in zip(codes, operands)):
                raise AssertionError(f"flash int8 {name} {dtype}: codes or scales differ from "
                                     "int8_operands")
            float_err = float((got.float() - attn_ops.qkv_plain(q, k, v).float()).abs().max())
            whole, alone = kc.flash_int8_work(q, k, v)
            b_ms, b_by = bound(whole[0], whole[1], torch.int8, whole[2])
            kb_ms, kb_by = bound(alone[0], alone[1], torch.int8, alone[2])
            ms = device_ms(lambda: attn_ops.flash_attention_int8(q, k, v))
            kernel_ms = device_ms(lambda: attn_ops.flash_attention_int8(q, k, v, operands))
            quantize_ms = device_ms(lambda: attn_ops.flash_int8_quantize(q, k, v))
            float_ms = device_ms(lambda: attn_ops.flash_attention(q, k, v))
            plain_ms = device_ms(lambda: attn_ops.flash_attention_int8_plain(q, k, v), n=5)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            row = dict(shape=name, dtype=dtype_name(dtype), B=B, Lq=Lq, Lk=Lk, d=d,
                       launches_per_frame={"tiny": per_tiny, "base": per_base},
                       geometry=attn_ops.flash_launch_geometry(B, Lq, Lk, d, "int8"),
                       max_abs_err=err, err_vs_float_attention=float_err, ms=ms,
                       kernel_ms=kernel_ms, quantize_ms=quantize_ms, float_kernel_ms=float_ms,
                       plain_ms=plain_ms, tops=whole[1] / ms / 1e9,
                       kernel_tops=whole[1] / kernel_ms / 1e9, bound_ms=b_ms, bound_by=b_by,
                       kernel_bound_ms=kb_ms, kernel_bound_by=kb_by, library_ms=lib_ms)
            if name == "decoder":
                qh, kh, vh = (kc.heads_layout(t) for t in (q, k, v))
                goth = attn_ops.multi_head_attention(qh, kh, vh, B, int8=True)
                torch.cuda.synchronize()
                herr = float((goth.float() - kc.heads_layout(want).float()).abs().max())
                if not np.isfinite(herr) or herr > FLASH_INT8_TOL[dtype] * scale:
                    raise AssertionError(f"flash int8 {name} {dtype}, heads where they lie: "
                                         f"max abs err {herr} vs {scale}")
                row["heads_max_abs_err"] = herr
                row["heads_ms"] = device_ms(
                    lambda: attn_ops.multi_head_attention(qh, kh, vh, B, int8=True))
                row["device_kernels"] = kc.device_kernels(
                    lambda: attn_ops.multi_head_attention(qh, kh, vh, B, int8=True))
                if row["device_kernels"] is not None and len(row["device_kernels"]) > 3:
                    raise AssertionError(f"flash int8: one call launched {row['device_kernels']}")
            rows.append(row)
            log(f"flash int8 {name:8s} {row['dtype']:9s} err {err:.3e} (vs float attention "
                f"{float_err:.3e})  op {ms * 1e3:.2f} us  kernel alone {kernel_ms * 1e3:.2f} us  "
                f"quantize {quantize_ms * 1e3:.2f} us  (float kernel {float_ms * 1e3:.2f} us)  "
                f"plain {plain_ms:.4f} ms  sdpa {lib_ms * 1e3:.2f} us  bound {b_ms * 1e3:.2f} us "
                f"({b_by}), kernel alone {kb_ms * 1e3:.2f} us"
                + (f"  device kernels a call {launch_count(row['device_kernels'])}"
                   if "device_kernels" in row else ""))
    return rows


def phase_dcn_int8(dev, gen):
    """The op from the int8 table (the fused kernel, both activation dtypes)
    against its plain version, NCHW and NHWC; the gather table's int8 codes
    against `quantize_dcn_table` (bit for bit) with one channel group far
    louder than the rest and one silent; the int8 im2col kernel (the old
    route, the yardstick) against its plain version.  `op_ms` is the whole
    op under quant="int8" (the table kernel, then the fused kernel),
    `table_ms` the table kernel with its scale, `route_ms` the parent's route
    (the table by plain passes, the int8 im2col kernel, the product), `ms` the
    int8 im2col kernel alone on a table made ahead."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in DCN_INT8_SHAPES.items():
            N, Cin, H, W, Cout, stride, dg, per_base, per_small, groups = spec
            chg = dcn_ops.dcn_ch_group(Cin)
            errs, im2col_errs = {}, {}
            for layout in ("NHWC", "NCHW"):  # the timings below use the model's NCHW
                x, off, mask, weight, geo = kc.dcn_inputs(spec, dtype, gen, dev, layout)
                c_axis = 3 if layout == "NHWC" else 1
                x.narrow(c_axis, 0, chg).mul_(7.0)
                x.narrow(c_axis, Cin - chg, chg).zero_()
                codes, scale = dcn_ops.dcn_gather_table(x, layout, chg)
                q, want_scale = dcn_ops.quantize_dcn_table(x, chg, layout)
                want_codes = q if layout == "NHWC" else q.permute(0, 2, 3, 1)
                if not (torch.equal(scale, want_scale) and torch.equal(codes, want_codes)
                        and bool((codes[..., Cin - chg:] == 0).all())):
                    raise AssertionError(f"dcn gather table codes {name} {layout} {dtype}")
                got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, quant="int8",
                                                      **geo)
                want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, None,
                                                             quant="int8", **geo)
                torch.cuda.synchronize()
                errs[layout] = max_err(got, want, dtype, f"dcn int8 op {name} {layout} {dtype}")
                col = dcn_ops.deform_im2col_int8(q, scale, off, mask, (3, 3), **geo)
                col_plain = dcn_ops.deform_im2col_int8_plain(q, scale, off, mask, (3, 3), **geo)
                torch.cuda.synchronize()
                im2col_errs[layout] = max_err(col, col_plain, dtype,
                                              f"dcn int8 im2col {name} {layout} {dtype}")
                del col, col_plain, codes, want_codes
            full = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, **geo)
            table_err = float((got.float() - full.float()).abs().max() / full.float().abs().max())
            if not 1e-4 < table_err < 5e-2:
                raise AssertionError(f"dcn int8 op {name} {dtype}: {table_err} from the "
                                     "floating-point op; the int8 table is not in use")
            del got, want, full

            esz = x.element_size()
            nbytes, flops, col_bytes = kc.dcn_work(spec, esz, 1, scale.numel() * 4)
            b_ms, b_by = bound(nbytes, flops, dtype)
            op_b_ms, op_b_by = bound(*kc.dcn_op_work(spec, esz, scale.numel() * 4), dtype)
            ms = device_ms(lambda: dcn_ops.deform_im2col_int8(q, scale, off, mask, (3, 3), **geo))
            table_ms = device_ms(lambda: dcn_ops.dcn_gather_table(x, "NCHW", chg))
            table_plain_ms = device_ms(lambda: dcn_ops.dcn_gather_table_plain(x, "NCHW", chg))
            t_b_ms, _ = bound(x.numel() * (esz + 1) + scale.numel() * 4, 0, dtype)
            wmat = dcn_ops.dcn_weight_matrix(weight, dtype)  # kept, as the model keeps it
            op_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d(
                x, off, mask, weight, None, quant="int8", wmat=wmat, **geo))
            route_ms = device_ms(lambda: dcn_ops.col_product(
                dcn_ops.deform_im2col_int8(*dcn_ops.quantize_dcn_table(x, chg), off, mask, (3, 3),
                                           **geo), weight, None, (H - 1) // stride + 1,
                (W - 1) // stride + 1, "NCHW"))
            plain_ms = device_ms(lambda: dcn_ops.deform_im2col_int8_plain(
                q, scale, off, mask, (3, 3), **geo), n=2, repeats=3)
            op_plain_ms = device_ms(lambda: dcn_ops.modulated_deform_conv2d_plain(
                x, off, mask, weight, None, quant="int8", **geo), n=2, repeats=3)
            gemm_flops = 2 * N * Cout * 9 * Cin * ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
            row = dict(shape=name, dtype=dtype_name(dtype), x=[N, Cin, H, W], Cout=Cout,
                       stride=stride, ch_group=chg,
                       launches_per_frame={"base": per_base, "small": per_small},
                       max_abs_err=im2col_errs["NCHW"], max_abs_err_nhwc=im2col_errs["NHWC"],
                       op_max_abs_err=errs["NCHW"], op_max_abs_err_nhwc=errs["NHWC"],
                       err_vs_float_op=table_err, ms=ms, table_ms=table_ms,
                       table_plain_ms=table_plain_ms, table_bound_ms=t_b_ms,
                       table_bound_by="bytes", table_max_abs_err=0.0, op_ms=op_ms,
                       route_ms=route_ms, plain_ms=plain_ms, op_plain_ms=op_plain_ms,
                       bound_ms=b_ms, bound_by=b_by, op_bound_ms=op_b_ms, op_bound_by=op_b_by,
                       library_ms=None, column_mb=col_bytes / 1e6,
                       op_tflops=gemm_flops / op_ms / 1e9)
            rows.append(row)
            log(f"dcn int8 {name:9s} {row['dtype']:9s} err op NCHW {errs['NCHW']:.3e} NHWC "
                f"{errs['NHWC']:.3e} (vs float op {table_err:.3e}), codes exact  op {op_ms:.4f} ms "
                f"(table {table_ms:.4f}; bound {op_b_ms * 1e3:.1f} us, {op_b_by})  parent route "
                f"{route_ms:.4f} ms  int8 im2col {ms:.4f} ms (err {im2col_errs['NCHW']:.3e})  "
                f"plain op {op_plain_ms:.3f} ms")
            del x, off, mask, weight, q, scale, wmat
            torch.cuda.empty_cache()
    return rows


PROBE_SPAN = {"sca_base": 4, "sca_tiny": 2}  # one locality per shape here; the tool sweeps


def phase_probes(dev, gen):
    """The two gather probes against their plain versions (bit for bit for
    the row gather; float32 sums in another order for the blend) at the base
    and tiny cross-attention shapes, `torch.gather` timed beside
    `gather_rows` and `F.embedding_bag` beside `gather_blend` (and held
    against it); the MSDA kernel's own gather, replayed through
    `gather_blend`, against the MSDA plain version; then the kernel bench
    tool, driven as a user would, as the path that launches them."""
    rows = {"gather_rows": [], "gather_blend": []}
    for name, spec in PROBE_SHAPES.items():
        B, keys, nq, taps, width = spec[:5]
        idx, w = probe_ops.make_workload(np.random.default_rng(0), B, nq, taps, keys,
                                         PROBE_SPAN[name], width)
        idx, w = torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
        flat = idx.reshape(B, -1)
        for dtype in kc.PROBE_DTYPES:
            table = kc.probe_table(B, keys, dtype, gen, dev)
            got = probe_ops.gather_rows(table, flat)
            want = probe_ops.gather_rows_plain(table, flat)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows {name} {dtype}: not the gathered rows")
            del got, want
            got = probe_ops.gather_blend(table, idx, w)
            want = probe_ops.gather_blend_plain(table, idx, w)
            torch.cuda.synchronize()
            err = max_err(got, want, torch.float32, f"gather_blend {name} {dtype}")
            del got, want
            torch.cuda.empty_cache()
            common = dict(shape=name, dtype=dtype_name(dtype), tables=B, keys=keys, queries=nq,
                          taps=taps, span=PROBE_SPAN[name])
            b_ms, b_by = bound(*kc.gather_rows_work(table, flat), torch.float32)
            ms = device_ms(lambda: probe_ops.gather_rows(table, flat), n=5, repeats=3)
            lib_ms = device_ms(lambda: probe_ops.gather_rows_plain(table, flat), n=3, repeats=3)
            rows["gather_rows"].append(dict(common, max_abs_err=0.0, ms=ms, plain_ms=lib_ms,
                                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
            log(f"gather_rows  {name:9s} {common['dtype']:9s} exact  kernel {ms:.4f} ms  "
                f"torch.gather {lib_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})")
            b_ms, b_by = bound(*kc.gather_blend_work(table, idx), torch.float32)
            ms = device_ms(lambda: probe_ops.gather_blend(table, idx, w), n=5, repeats=3)
            plain_ms = device_ms(lambda: probe_ops.gather_blend_plain(table, idx, w), n=2,
                                 repeats=2)
            # the library's call: float32 sums for float32 rows, bfloat16
            # weights and output for bfloat16 rows, none for int8 rows
            lib_ms = lib_err = None
            library = kc.gather_blend_library(table, idx, w)
            if library is not None:
                lib_err = max_err(library().float(), probe_ops.gather_blend(table, idx, w),
                                  dtype, f"embedding_bag vs gather_blend {name} {dtype}")
                lib_ms = device_ms(library, n=3, repeats=3)
            del library
            rows["gather_blend"].append(dict(common, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, library_max_abs_err=lib_err,
                                             bound_ms=b_ms, bound_by=b_by))
            log(f"gather_blend {name:9s} {common['dtype']:9s} err {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  embedding_bag "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
                f"bound {b_ms * 1e3:.2f} us ({b_by})")
            del table
            torch.cuda.empty_cache()
        del idx, w, flat

    # MSDA's own gather through the probe: the same function by another kernel
    (value, ref, off, attn), shapes = kc.msda_inputs(MSDA_SHAPES["sca"], torch.float32, gen, dev)
    table, idx, w = kc.msda_gather_operands(value, ref, off, attn, shapes)
    bs, nq, heads, ch = value.shape[0], ref.shape[1], value.shape[2], value.shape[3]
    got = probe_ops.gather_blend(table, idx, w).reshape(bs, heads, nq, ch)
    got = got.permute(0, 2, 1, 3).reshape(bs, nq, heads * ch)
    want = msda_ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes)
    replay_err = max_err(got, want, torch.float32, "gather_blend on MSDA's indices")
    log(f"gather_blend on the MSDA kernel's indices and weights (tiny SCA) vs MSDA plain: "
        f"err {replay_err:.3e}")
    del value, ref, off, attn, table, idx, w, got, want
    torch.cuda.empty_cache()

    reset_launch_counts()
    t0 = time.perf_counter()
    if kernel_bench.main(["--parts", "probes", "split", "--shapes", "sca_tiny"]) != 0:
        raise AssertionError("the kernel bench tool failed")
    torch.cuda.synchronize()
    launches = dict(zip(COUNT_NAMES, launch_counts()))
    log(f"kernel bench tool (probes at the tiny shape, MSDA split at base and tiny) took "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return dict(rows=rows, launches=launches, msda_replay_err=replay_err)


def phase_int8_frame(make_cfg, card, exclude, want, scales=None, calib_frames=1,
                     latency_frames=3):
    """One frame of a model under quant="int8" on the kernel path with its
    launch counts asserted (`want` as in `phase_int8_model`), finite outputs
    of the right shape, then the frame latency.  `scales` are calibrated
    here (`max`) unless given."""
    over = {} if exclude is None else {"quant_exclude": exclude}
    cfg = make_cfg(quant="int8", **over)
    name = f"{cfg.name} int8, excluded {list(cfg.quant_exclude)}"
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("scene-A",))
    check_rig(cfg, frames)
    if scales is None:
        t0 = time.perf_counter()
        qdq = BEVFormerEngine(make_cfg(quant=True, quant_exclude=cfg.quant_exclude), seed=0)
        calib = synthetic_frames(cfg, np.random.default_rng(1), ("calib",) * calib_frames)
        scales = qdq.calibrate(calib, method="max").scales
        log(f"{name}: {len(scales)} sites calibrated (max, {calib_frames} frame) in "
            f"{time.perf_counter() - t0:.1f} s")
        del qdq
        torch.cuda.empty_cache()
    engine = BEVFormerEngine(cfg, seed=0)
    attach_quant_scales(engine.model, scales)
    _, layer_calls, not_int8 = record_gemm_shapes(engine, frames[0])  # also the warm-up
    if not_int8:
        raise AssertionError(f"{name}: {not_int8} dense or conv layers do not run int8")
    msda, flash, dcn, msda8, flash8, dcn8 = want
    want = counts_of(msda=msda, flash_attn=flash, dcn_im2col=dcn, int8_gemm=layer_calls,
                     msda_int8=msda8, flash_int8=flash8, dcn_int8=dcn8, dcn_table=dcn8)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (bev, classes, coords), = run_frames(engine, frames)
    counts = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"{name} main path: launches {dict(zip(COUNT_NAMES, counts))}, peak device memory "
        f"{peak_mb:.0f} MB")
    if counts != want:
        raise AssertionError(f"{name}: expected {want} launches per frame, got {counts}")
    shapes = tuple(tuple(t.shape) for t in (bev, classes, coords))
    if shapes != ((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), (6, 1, 900, 10), (6, 1, 900, 10)):
        raise AssertionError(f"{name} output shapes {shapes}")
    for what, t in (("bev_embed", bev), ("classes", classes), ("coords", coords)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} {what}: non-finite values")
    lat = frame_latency(engine, frames, latency_frames)
    log(f"{name} f32 activations, frame latency: median {np.median(lat):.3f} ms over "
        f"{len(lat)} frames (min {min(lat):.3f}, max {max(lat):.3f}) on {card}")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=dict(zip(COUNT_NAMES, counts)), latency_ms_median=float(np.median(lat)),
                latency_ms=lat, int8_layer_calls_per_frame=layer_calls, peak_memory_mb=peak_mb)


def phase_checkpoint(card):
    """One tiny frame from an engine built through `load_bevformer_checkpoint`
    out of a seeded state_dict in the upstream layout, against the engine
    that holds the same tensors in the port's layout: bit for bit."""
    cfg = bevformer_tiny()
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("scene-A",))
    direct = BEVFormerEngine(cfg, seed=0)
    port_sd = {k: v.detach().cpu() for k, v in direct.model.state_dict().items()}
    upstream = upstream_layout(cfg, port_sd)
    upstream["img_backbone.bn1.num_batches_tracked"] = torch.tensor(0)  # as real files carry
    loaded_sd = load_bevformer_checkpoint(cfg, upstream)
    if sorted(loaded_sd) != sorted(port_sd) or not all(
            torch.equal(loaded_sd[k], port_sd[k]) for k in port_sd):
        raise AssertionError("checkpoint loader: tensors differ from the port-layout state_dict")
    loaded = BEVFormerEngine(cfg, state_dict=loaded_sd)
    want, got = run_frames(direct, frames)[0], run_frames(loaded, frames)[0]
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("checkpoint loader: the loaded engine's frame differs")
    log(f"tiny through load_bevformer_checkpoint: {len(upstream)} upstream keys -> "
        f"{len(loaded_sd)} tensors, one frame bit-identical to the port-layout engine on {card}")
    del direct, loaded
    torch.cuda.empty_cache()
    return dict(upstream_keys=len(upstream), tensors=len(loaded_sd))


COUNT_NAMES = ("msda", "flash_attn", "dcn", "int8_gemm", "msda_int8", "flash_int8", "dcn_int8",
               "dcn_table", "gather_rows", "gather_blend", "dcn_im2col", "dcn_im2col_int8")


def launch_counts():
    return tuple(fn.launches for fn in KERNEL_WRAPPERS)


def counts_of(**named):
    """A tuple of launch counts in KERNEL_WRAPPERS' order, 0 where not named."""
    unknown = set(named) - set(COUNT_NAMES)
    if unknown:
        raise KeyError(f"no launch counter {sorted(unknown)}")
    return tuple(named.get(n, 0) for n in COUNT_NAMES)


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
                     latency_frames, bf16, scales_out=None):
    """One model under quant="int8" at full width: calibrate its QDQ tier on
    the card, attach and fold the scales into the int8 tier of the same
    weights, run frames on the kernel path (launch counts read after each)
    and on the plain path, compare with the QDQ simulation and with floating
    point, take the frame latency, and time the int8 product at every shape
    the frame launched.  `want` = per-frame launches (MSDA, flash, DCN,
    int8-table MSDA, int8 flash, int8-table DCN); the int8 product's count
    must equal the forward calls of the int8 layers.  The calibrated scales
    are also put into the dict `scales_out`, where one is given."""
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
    msda, flash, dcn, msda8, flash8, dcn8 = want
    # the DCN op: the float table on the im2col route (float32 activations),
    # the int8 table on the fused kernel with its gather table
    per_frame_want = counts_of(msda=msda, flash_attn=flash, dcn_im2col=dcn, int8_gemm=layer_calls,
                               msda_int8=msda8, flash_int8=flash8, dcn_int8=dcn8, dcn_table=dcn8)
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
    res_backbone = {}
    if dcn8:
        # the fused kernel sums its corners and products in another order than
        # its plain version, ahead of every later quantization step of the backbone
        with plain_versions(["dcn_int8"]), torch.inference_mode():
            plain_feats = engine.model.img_neck(engine.model.img_backbone(image))
        errs = [rel_errors(a, b) for a, b in zip(feats, plain_feats)]
        res_backbone = {"neck_rel_err_dcn_int8_kernel_vs_plain": errs}
        log(f"{name}: FPN levels with the int8-table DCN on its kernel against its plain version: "
            + ", ".join(f"max {e['max']:.3e} rms {e['rms']:.3e}" for e in errs))
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
               latency_ms_median=float(np.median(lat)), latency_ms=lat, peak_memory_mb=peak_mb,
               **res_backbone)
    if scales_out is not None:
        scales_out.update(result.scales)
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
    msda, flash, dcn = per_frame_want
    # float32: the DCN op takes the im2col route (the dtype rule of ops/dcn.py)
    per_frame_want = counts_of(msda=msda, flash_attn=flash, dcn_im2col=dcn)
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
    reset_launch_counts()
    got16 = run_frames(engine16, frames)
    launches16 = dict(zip(COUNT_NAMES, launch_counts()))
    # bfloat16: the fused DCN kernel and its gather table, no im2col
    want16 = counts_of(msda=msda, flash_attn=flash, dcn=dcn, dcn_table=dcn)
    if launch_counts() != tuple(3 * n for n in want16):
        raise AssertionError(f"{name} bf16: expected {want16} launches per frame over 3 frames, "
                             f"got {launches16}")
    log(f"{name} bf16 main path: launches over 3 frames {launches16}")
    plain16 = run_plain(engine16, frames)
    torch.cuda.reset_peak_memory_stats()
    lat16 = frame_latency(engine16, frames, latency_frames)
    latency16 = float(np.median(lat16))
    peak16_mb = torch.cuda.max_memory_allocated() / 1e6
    err16 = compare_frames(got16, plain16, f"{name} bf16 kernel vs plain", rms_tol=BF16_RMS_TOL)
    drift_k = compare_frames(got16, plain, f"{name} bf16 kernel vs f32 plain")["rms"]
    drift_p = compare_frames(plain16, plain, f"{name} bf16 plain vs f32 plain")["rms"]
    if not drift_k <= 1.5 * drift_p + 1e-3:
        raise AssertionError(
            f"{name}: bf16 kernel path drifts {drift_k} from float32, plain path {drift_p}")
    log(f"{name} bf16 frame latency: median {latency16:.3f} ms over {len(lat16)} frames "
        f"(min {min(lat16):.3f}, max {max(lat16):.3f}), peak device memory {peak16_mb:.0f} MB, "
        f"on {card}")
    del engine16
    torch.cuda.empty_cache()
    return dict(launches=launches, launches_bf16=launches16, frames=len(frames),
                rel_err_f32=err32, rel_err_bf16=err16,
                bf16_drift_kernel=drift_k, bf16_drift_plain=drift_p,
                latency_ms_median=latency, latency_ms=lat, latency_ms_median_bf16=latency16,
                latency_ms_bf16=lat16, peak_memory_mb=peak_mb, peak_memory_mb_bf16=peak16_mb)


def phase_small(card):
    """One BEVFormer-small frame at full width on the kernel path, float32
    (the DCN op on its im2col route) and bfloat16 (the fused DCN kernel)."""
    res = {}
    for dtype, dcn_counts in (("float32", dict(dcn_im2col=26)),
                              ("bfloat16", dict(dcn=26, dcn_table=26))):
        cfg = bevformer_small(dtype=dtype)
        frames = synthetic_frames(cfg, np.random.default_rng(0), ("scene-A",))
        check_rig(cfg, frames)
        engine = BEVFormerEngine(cfg, seed=0)
        run_frames(engine, frames)  # warm-up
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (bev, classes, coords), = run_frames(engine, frames)
        ms = (time.perf_counter() - t0) * 1e3
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        counts = launch_counts()
        want = counts_of(msda=12, flash_attn=6, **dcn_counts)
        log(f"small {dtype} main path: launches {dict(zip(COUNT_NAMES, counts))}; frame "
            f"{ms:.3f} ms, peak device memory {peak_mb:.0f} MB on {card}")
        if counts != want:
            raise AssertionError(f"small {dtype}: expected {want} launches per frame, got {counts}")
        shapes = tuple(tuple(t.shape) for t in (bev, classes, coords))
        if shapes != ((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), (6, 1, 900, 10),
                      (6, 1, 900, 10)):
            raise AssertionError(f"small output shapes {shapes}")
        for what, t in (("bev_embed", bev), ("classes", classes), ("coords", coords)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"small {dtype} {what}: non-finite values")
        res[dtype] = dict(launches=dict(zip(COUNT_NAMES, counts)), frame_ms=ms,
                          peak_memory_mb=peak_mb)
        del engine
        torch.cuda.empty_cache()
    return res


def frame_sums(rows, frame, library, extra=(), dtype="float32", key="launches_per_frame"):
    """The `dtype` launches of one `frame` (tiny, base) at the main path's
    shapes, summed: ms per frame.  `extra` names further row keys to sum."""
    main = [r for r in rows if r["dtype"] == dtype and r[key].get(frame)]

    def tot(k):
        return float(sum(r[k] * r[key][frame] for r in main))

    return {
        "launches_per_frame": sum(r[key][frame] for r in main),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_us": tot("bound_ms") * 1e3,
        "bound_by": max(main, key=lambda r: r["bound_ms"] * r[key][frame])["bound_by"],
        "library_ms": tot("library_ms") if library else None,
        **{k: tot(k) for k in extra},
    }


def kernel_entry(name, source, replaces, rows, library, frame, launches, also=None, extra=(),
                 note="", dtype="float32"):
    """One entry of the kernels line.  Its numbers are sums over one
    `frame`'s `dtype` launches; `launches` is the count of that model's
    main-path run.  `also` = (frame, launches) adds another model's sums and
    count under keys prefixed with its name; `extra` row keys are summed
    too and `note` is appended to the entry's `per`."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, **frame_sums(rows, frame, library, extra, dtype),
             "per": f"one {frame} frame: the sum over its {dtype} launches at the main "
                    f"path's shapes{note}"}
    if also:
        other, count = also
        entry[f"{other}_launches"] = count
        entry.update({f"{other}_{k}": v
                      for k, v in frame_sums(rows, other, library, (), dtype).items()})
    entry["shapes"] = rows
    return entry


def fused_rows(rows, int8):
    """The fused kernel's rows of the DCN phases in the kernels line's terms:
    `ms` the whole op (the gather table and the fused kernel), `bound_ms` the
    op's bound, `plain_ms` the plain op, `route_ms` the parent's route
    (im2col kernel, then the product), `conv2d_ms` cuDNN's `F.conv2d` of the
    same shape where it was timed (a yardstick: not the same function, so
    `library_ms` is null); only the dtypes that run the fused kernel
    (bfloat16 for the float map, both for the int8 table)."""
    return [dict(r, ms=r["op_ms"], bound_ms=r["op_bound_ms"], bound_by=r["op_bound_by"],
                 plain_ms=r["op_plain_ms"], max_abs_err=r["op_max_abs_err"], library_ms=None,
                 conv2d_ms=r.get("op_library_ms"), im2col_ms=r["ms"],
                 im2col_bound_ms=r["bound_ms"])
            for r in rows if int8 or r["dtype"] == "bfloat16"]


def table_rows(rows):
    """The gather table kernel's rows: the kernels line's keys from the
    `table_*` measurements of the DCN phases."""
    return [dict(r, ms=r["table_ms"], plain_ms=r["table_plain_ms"],
                 bound_ms=r["table_bound_ms"], bound_by=r["table_bound_by"],
                 max_abs_err=r["table_max_abs_err"], library_ms=None)
            for r in rows if r.get("table_ms") is not None]


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
    base_scales = {}  # calibrated by base_int8, used again by the phase after it
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
            ("dcn_int8", lambda: phase_dcn_int8(dev, gen)),
            ("probes", lambda: phase_probes(dev, gen)),
            ("checkpoint", lambda: phase_checkpoint(card)),
            ("tiny_int8", lambda: phase_int8_model(
                bevformer_tiny, card, dev, gen, exclude=None, want=(3, 0, 0, 9, 6, 0),
                calib_frames=4, methods=("max", "entropy"), n_frames=3, latency_frames=6,
                bf16=True)),
            ("base_int8", lambda: phase_int8_model(
                bevformer_base, card, dev, gen, exclude=None, want=(6, 0, 0, 12, 6, 26),
                calib_frames=2, methods=("max",), n_frames=2, latency_frames=3, bf16=False,
                scales_out=base_scales)),
            # the QDQ tier does not see the policy of the tables, so the same
            # scales serve the variant that keeps the DCN tables floating point
            ("base_int8_float_dcn_tables", lambda: phase_int8_frame(
                bevformer_base, card, exclude=("self_attn/msda_tables", "dcn_tables"),
                want=(6, 0, 26, 12, 6, 0), scales=base_scales)),
            ("small_int8", lambda: phase_int8_frame(
                bevformer_small, card, exclude=None, want=(3, 0, 0, 9, 6, 26)))):
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
                     also=("small", res["small"]["float32"]["launches"]["dcn_im2col"]),
                     extra=("op_ms", "op_plain_ms", "op_library_ms"),
                     note="; the float32 map's route (the dtype rule of ops/dcn.py); no library "
                          "call computes a deformable im2col, so library_ms is null; op_ms is "
                          "the whole op (im2col, then the product with the weight) and "
                          "op_library_ms cuDNN's ordinary F.conv2d of the same shape, a "
                          "yardstick for the op only"),
        kernel_entry("dcn_fused", "bevformer_tensorrt_tpu_torch/csrc/dcn_fused.cu",
                     "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247 (im2col mode, with "
                     "the product of bevformer_tensorrt_tpu/ops/dcn.py:231)",
                     fused_rows(res["dcn"], False), False, "base",
                     res["base"]["launches_bf16"]["dcn"],
                     also=("small", res["small"]["bfloat16"]["launches"]["dcn"]),
                     extra=("route_ms", "conv2d_ms", "table_ms"), dtype="bfloat16",
                     note="; the whole op: the gather table, then the fused kernel; route_ms "
                          "the parent's route (im2col kernel, then the product) and conv2d_ms "
                          "cuDNN's ordinary F.conv2d of the same shape, a yardstick (no library "
                          "call computes the op, so library_ms is null); launches over the "
                          "three bfloat16 frames"),
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
    flash8_note = ("; ms is the whole op (amax, quantize and attention launches), kernel_ms the "
                   "attention kernel alone on operands quantized ahead, quantize_ms the amax "
                   "and quantize launches, float_kernel_ms the floating-point kernel at the "
                   "same shape")
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
                     also=("base", base8["launches"]["flash_int8"]),
                     extra=extra + ("quantize_ms",), note=flash8_note),
    ]
    small8, probes = res["small_int8"], res["probes"]
    kernels.append(kernel_entry(
        "dcn_fused_int8", "bevformer_tensorrt_tpu_torch/csrc/dcn_fused.cu",
        "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247 (packed='int8' from "
        "bevformer_tensorrt_tpu/ops/dcn.py:215-230)",
        fused_rows(res["dcn_int8"], True), False, "base", base8["launches"]["dcn_int8"],
        also=("small", small8["launches"]["dcn_int8"]), extra=("route_ms", "table_ms"),
        note="; the whole op under quant='int8': the gather table's int8 codes, then the fused "
             "kernel (FFMA product for float32 activations); route_ms the parent's route (the "
             "table by plain passes, the int8 im2col kernel, the product); no library call "
             "computes the op"))
    kernels.append(kernel_entry(
        "dcn_gather_table", "bevformer_tensorrt_tpu_torch/csrc/dcn_fused.cu",
        "bevformer_tensorrt_tpu/ops/dcn.py:146-158 (the int8 table's codes, and the "
        "channels-last layout of the tables the TPU kernel gathers from)",
        table_rows(res["dcn_int8"]), False, "base", base8["launches"]["dcn_table"],
        also=("small", small8["launches"]["dcn_table"]),
        note="; the int8 codes from the float32 map with its scale; plain_ms the plain "
             "quantization and transposition; the bfloat16 frames' float tables are rows of "
             "the shapes list (dtype bfloat16, codes false)"))
    kernels[-1]["shapes"] = table_rows(res["dcn_int8"]) + [
        dict(r, codes=False) for r in table_rows(res["dcn"])]
    yardstick = kernel_entry(
        "dcn_im2col_int8", "bevformer_tensorrt_tpu_torch/csrc/dcn.cu",
        "bevformer_tensorrt_tpu/ops/pallas/msda_gather.py:247 (packed='int8' from "
        "bevformer_tensorrt_tpu/ops/dcn.py:347)",
        res["dcn_int8"], False, "base", base8["launches"]["dcn_im2col_int8"],
        also=("small", small8["launches"]["dcn_im2col_int8"]),
        extra=("table_ms", "op_ms", "route_ms"),
        note="; the int8 table's old route, off every model path since the fused kernel (a "
             "yardstick: launches 0); ms is the kernel alone on a table made ahead; no library "
             "call computes a deformable im2col")
    yardstick["main_path"] = False
    kernels.append(yardstick)
    for name, replaces in (
            ("gather_rows", "tools/kernel_bench.py:96 (also tools/gather_bench.py:90, :107 and "
                            "tools/kernel_bench3.py:77 variant F)"),
            ("gather_blend", "tools/kernel_bench.py:140 (also tools/kernel_bench2.py:134, :190, "
                             ":240 and tools/kernel_bench3.py:77 variants A-C)")):
        rows = probes["rows"][name]
        main_rows = [r for r in rows if r["shape"] == "sca_base" and r["dtype"] == "float32"]
        row = main_rows[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bevformer_tensorrt_tpu_torch/csrc/gather_probe.cu", "replaces": replaces,
            "launches": probes["launches"][name],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "max_abs_err_all_shapes": max(r["max_abs_err"] for r in rows),
            "per": "one launch at the base cross-attention shape (48 tables of 30825 keys, "
                   "14080 queries, 32 taps, 4 corners), float32 rows, span 4; library_ms is "
                   "torch.gather for gather_rows and F.embedding_bag with per-sample weights "
                   "for gather_blend; launches is the count of one run of the kernel bench "
                   "tool",
            "shapes": rows})
    for k in kernels:
        if k.get("main_path", True) and (k["launches"] < 1 or k.get("base_launches", 1) < 1
                                         or k.get("small_launches", 1) < 1):
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
