"""Kernel bench of the port: the gather probes over a locality sweep, every
production kernel at the models' shapes beside its bound, and what share of
the MSDA kernel's time is the gather.

    python -m bevformer_tensorrt_tpu_torch.tools.kernel_bench [--span N ...]
        [--shapes sca_base sca_tiny]
        [--parts probes production split dcn_split flash dispatch]
        [--build-report] [--out FILE] [--device cuda]

It takes the place of the JAX package's TPU design-space probes
(`tools/kernel_bench.py`, `kernel_bench2.py`, `kernel_bench3.py`,
`gather_bench.py`, `kernel_compile_bisect.py`).  What those asked of Mosaic
(one-hot products, wide windows, panel visits, the compile bisection) has no
counterpart on a GPU; what is left is

  probes      `gather_rows` and `gather_blend` (`csrc/gather_probe.cu`) for
              float32, bfloat16 and int8 rows of 32 channels, at the shape of
              the spatial cross-attention gather of base (48 tables of 30825
              keys, 14080 queries, 32 taps) and of tiny, over `span`: the
              128-key panels that the indices of 128 consecutive taps fall
              into (1 = as local as a convolution, the table's panel count =
              no locality).  `torch.gather` is timed beside `gather_rows`,
              and `F.embedding_bag` with per-sample weights beside
              `gather_blend` (float32 and bfloat16 rows; it takes no int8).
  production  the kernels of the models at the shapes the models give them
              (`tools/kernel_cases.py`), each beside its bound; the int8
              product's rows name the tile configuration and give TOP/s, the
              fraction of the bound reached and `torch._int_mm`'s time where
              it takes the shape; the DCN op's rows (from the float map and
              from the int8 table) give TFLOP/s, the parent's route (im2col
              kernel, then the product) and cuDNN's `F.conv2d` of the shape.
  split       MSDA at its base and tiny cross-attention shapes: the bare
              gather of the rows the kernel reads, the gather with the blend,
              and the whole kernel, at the same indices and weights,
              with `F.embedding_bag` on them as the library's time.
  dcn_split   (asked for by name) the fused DCN kernel at base's and small's shapes, for each
              operand kind (bfloat16 map, int8 table with float32
              activations, float32 map) and each tile configuration: the
              kernel alone (gather table made ahead), then without its corner
              loads (the sampled tiles blend zeros) and without its product,
              with the blocks an SM holds; the table, the whole op, the
              parent's route and `F.conv2d` beside them.
  flash       (asked for by name) both attention ops at their shapes, per
              dtype: the floating-point kernel on [B, L, d] and on the heads
              where they lie, with SDPA and TFLOP/s; the int8 op whole, its
              attention kernel alone and its quantization alone; each
              kernel at 1, 2 and 4 row groups a block (the geometry rule
              picks one); the device kernels one call launches
              (torch.profiler).
  dispatch    (asked for by name; CUDA only) the host's cost of a call at
              each registered operator on a model path, at tiny's shapes (the
              DCN at base's stage 3): the launch function alone (checks,
              ctypes launch), the operator (`torch.ops.bevformer_port.*`: the
              dispatcher, then the same function) and the model's wrapper
              (the autograd Function around the operator), each as host us a
              call of 20 calls issued behind a device sleep (the card never
              makes the host wait) and as us a call of a loop that
              synchronises after every call, the layers timed in turn over
              15 rounds (median and least); then, per tiny and base frame
              (float and int8), the calls it makes and the ms the operators
              add to its host time (sum over calls of the medians' operator
              - launch).
  --build-report  compiles each source again on its own and prints nvcc's
              time and ptxas' registers and spills.

Prints one JSON object per line (`"part"` says which), after a line with
the card's name and power limit.  Times are CUDA-event times of
back-to-back launches behind a device sleep.  `--device cpu` is a rehearsal
at toy shapes: the wrappers run their plain versions, times are host times
under the key `cpu_ms`, and no bound is stated.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .. import ops
from ..ops import _cuda
from ..ops import attention as attn_ops
from ..ops import dcn as dcn_ops
from ..ops import gather_probe
from ..ops import int8_matmul as int8_ops
from ..ops import msda as msda_ops
from ..runtime.engine import resolve_device
from . import kernel_cases as kc

PARTS = ("probes", "production", "split", "dcn_split", "flash", "dispatch")
DEFAULT_PARTS = PARTS[:3]
DCN_KINDS = {  # operand kind: (activation dtype, int8 table)
    "bf16": (torch.bfloat16, False), "int8": (torch.float32, True),
    "f32": (torch.float32, False)}


class Bench:
    """The device, its timer and where the rows go."""

    def __init__(self, device, out_rows):
        self.dev = device
        self.cuda = device.type == "cuda"
        self.rows = out_rows
        self.gen = torch.Generator().manual_seed(0)

    def ms(self, fn, n=10, repeats=3):
        return kc.device_ms(fn, n, repeats) if self.cuda else kc.host_ms(fn)

    def emit(self, part, kernel, shape, t, work=None, dtype=None, **more):
        row = {"part": part, "kernel": kernel, "shape": shape, "device": self.dev.type,
               ("ms" if self.cuda else "cpu_ms"): t}
        if dtype is not None:
            row["dtype"] = kc.dtype_name(dtype)
        if work is not None and self.cuda:
            nbytes, flops, peak, *exps = work  # (bytes, flops, peak[, exponentials])
            row["bound_ms"], row["bound_by"] = kc.bound(nbytes, flops, peak, *exps)
            row["mbytes"], row["gflop"] = nbytes / 1e6, flops / 1e9
        row.update(more)
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        return row


def probe_operands(bench, spec, span, seed=0):
    B, keys, nq, taps, row = spec[:5]
    idx, w = gather_probe.make_workload(np.random.default_rng(seed), B, nq, taps, keys, span, row)
    return torch.from_numpy(idx).to(bench.dev), torch.from_numpy(w).to(bench.dev)


def run_probes(bench, shapes, spans):
    for name, spec in shapes.items():
        B, keys = spec[:2]
        panels = keys // 128
        for span in sorted({min(s, panels) for s in (spans or spec[5])}):
            idx, w = probe_operands(bench, spec, span)
            flat = idx.reshape(B, -1)
            for dtype in kc.PROBE_DTYPES:
                table = kc.probe_table(B, keys, dtype, bench.gen, bench.dev)
                more = dict(span=span, panels=panels, tables=B, keys=keys, queries=spec[2],
                            taps=spec[3])
                library = bench.ms(lambda: gather_probe.gather_rows_plain(table, flat), 3, 3)
                bench.emit("probes", "gather_rows", name,
                           bench.ms(lambda: ops.gather_rows(table, flat)),
                           (*kc.gather_rows_work(table, flat), torch.float32), dtype,
                           **more, **{"library_ms" if bench.cuda else "library_cpu_ms": library})
                library = kc.gather_blend_library(table, idx, w)
                if library is not None:
                    library = bench.ms(library, 3, 3)
                bench.emit("probes", "gather_blend", name,
                           bench.ms(lambda: ops.gather_blend(table, idx, w)),
                           (*kc.gather_blend_work(table, idx), torch.float32), dtype,
                           **more, **{"library_ms" if bench.cuda else "library_cpu_ms": library})
                del table
            del idx, w, flat
            if bench.cuda:
                torch.cuda.empty_cache()


def run_production(bench, shapes):
    """Every production kernel at each of its shapes: float32 and bfloat16
    activations for the floating-point kernels and the int8-table ones, the
    kernel alone (operands quantized ahead) where a wrapper quantizes."""
    dev, gen = bench.dev, bench.gen
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in shapes["msda"].items():
            (value, ref, off, attn), lv = kc.msda_inputs(spec, dtype, gen, dev)
            nbytes, flops, _ = kc.msda_work(value, ref, off, attn, lv)
            bench.emit("production", "msda", name, bench.ms(
                lambda: ops.multi_scale_deformable_attn(value, ref, off, attn, lv)),
                (nbytes, flops, dtype), dtype)
            if bench.cuda:
                table = msda_ops.quantize_value_table(value)
                _, alone = kc.msda_int8_work(value, ref, off, attn, lv)
                bench.emit("production", "msda_int8", name, bench.ms(
                    lambda: msda_ops._msda_cuda(value, ref, off, attn, lv, int8_table=table)),
                    (*alone, dtype), dtype, note="kernel alone, table quantized ahead")
            else:
                bench.emit("production", "msda_int8", name, bench.ms(
                    lambda: ops.multi_scale_deformable_attn_int8(value, ref, off, attn, lv)),
                    None, dtype)
        for name, spec in shapes["flash"].items():
            q, k, v = kc.flash_inputs(spec, dtype, gen, dev)
            nbytes, flops, exps = kc.flash_work(q, k, v)
            bench.emit("production", "flash_attn", name,
                       bench.ms(lambda: ops.flash_attention(q, k, v)),
                       (nbytes, flops, kc.flash_peak(dtype), exps), dtype)
            if spec[3] not in attn_ops.INT8_FLASH_HEAD_DIMS:
                continue
            operands = attn_ops.int8_operands(q, k, v) if bench.cuda else None
            _, (nbytes, ops8, exps) = kc.flash_int8_work(q, k, v)
            bench.emit("production", "flash_int8", name, bench.ms(
                lambda: (attn_ops._flash_int8_cuda(q, k, v, operands) if bench.cuda
                         else ops.flash_attention_int8(q, k, v))),
                (nbytes, ops8, torch.int8, exps), dtype,
                **({"note": "kernel alone, operands quantized ahead"} if bench.cuda else {}))
        for name, spec in shapes["dcn"].items():
            x, off, mask, weight, geo = kc.dcn_inputs(spec, dtype, gen, dev)
            esz, groups = x.element_size(), spec[9]
            Ho, Wo = off.shape[2:]
            bench.emit("production", "dcn_im2col", name, bench.ms(
                lambda: (dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo) if bench.cuda
                         else dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo))),
                (*kc.dcn_work(spec, esz)[:2], dtype), dtype)
            # the whole op (float32: the im2col route; bfloat16: the gather
            # table and the fused kernel) beside the parent's route and cuDNN
            more = {}
            if bench.cuda:
                wd = weight.to(dtype)
                more = dict(route_ms=bench.ms(lambda: dcn_ops.col_product(
                    dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo), weight, None, Ho, Wo,
                    "NCHW", groups)), conv2d_ms=bench.ms(
                    lambda: torch.nn.functional.conv2d(x, wd, None, spec[5], 1, 1, groups)))
            # the op as the model calls it, its weight matrix kept
            wmat = dcn_ops.dcn_weight_matrix(weight, dtype) if dtype == torch.bfloat16 else None
            t = bench.ms(lambda: ops.modulated_deform_conv2d(x, off, mask, weight, None,
                                                             groups=groups, wmat=wmat, **geo))
            flops = kc.dcn_op_work(spec, esz)[1]
            bench.emit("production", "dcn_op", name, t, (*kc.dcn_op_work(spec, esz), dtype),
                       dtype, route="fused" if dtype == torch.bfloat16 else "im2col",
                       **({"tflops": flops / t / 1e9} if bench.cuda else {}), **more)
            Cin = spec[1]
            if not dcn_ops.int8_table_eligible(Cin, groups, spec[6]):
                continue
            chg = dcn_ops.dcn_ch_group(Cin)
            q, scale = dcn_ops.quantize_dcn_table(x, chg)
            bench.emit("production", "dcn_im2col_int8", name, bench.ms(
                lambda: ops.deform_im2col_int8(q, scale, off, mask, (3, 3), **geo)),
                (*kc.dcn_work(spec, esz, 1, scale.numel() * 4)[:2], dtype), dtype,
                note="kernel alone, table quantized ahead")
            more = {}
            if bench.cuda:
                more = dict(route_ms=bench.ms(lambda: dcn_ops.col_product(
                    dcn_ops.deform_im2col_int8(*dcn_ops.quantize_dcn_table(x, chg), off, mask,
                                               (3, 3), **geo), weight, None, Ho, Wo, "NCHW")),
                            table_ms=bench.ms(lambda: dcn_ops.dcn_gather_table(x, "NCHW", chg)))
            wmat = dcn_ops.dcn_weight_matrix(weight, dtype)
            t = bench.ms(lambda: ops.modulated_deform_conv2d(x, off, mask, weight, None,
                                                             quant="int8", wmat=wmat, **geo))
            bench.emit("production", "dcn_op_int8", name, t,
                       (*kc.dcn_op_work(spec, esz, scale.numel() * 4), dtype), dtype,
                       route="fused", **({"tflops": flops / t / 1e9} if bench.cuda else {}),
                       **more)
    for name, (M, K, N) in shapes["gemm"].items():
        x, w, xs, ws = kc.gemm_case(M, K, N, gen, dev)
        t = bench.ms(lambda: int8_ops.int8_matmul(x, w, xs, ws))
        config = int8_ops.gemm_config(M, N, K + (-K) % int8_ops.K_ALIGN)  # K as the wrapper pads it
        more = dict(M=M, K=K, N=N, config=config)
        if bench.cuda:  # the rate, the share of the bound, and the library's int32 product
            wt = w.t()
            more.update(tops=2 * M * N * K / t / 1e9,
                        bound_fraction=kc.bound(*kc.gemm_work(M, K, N), torch.int8)[0] / t,
                        library_ms=(bench.ms(lambda: torch._int_mm(x, wt))
                                    if kc.int_mm_takes(M, K, N) else None))
        bench.emit("production", "int8_gemm", name, t,
                   (*kc.gemm_work(M, K, N), torch.int8), torch.int8, **more)
        del x, w
    if bench.cuda:
        torch.cuda.empty_cache()


def run_flash(bench, shapes):
    """Both attention ops at each shape, per dtype: the floating-point
    kernel on [B, L, d] and on the heads where they lie ([1, L, B * d]
    through `multi_head_attention`), SDPA beside it; the int8 op whole, its
    attention kernel alone (operands quantized ahead), its two quantization
    launches alone, and the device kernels one op call launches."""
    dev, gen = bench.dev, bench.gen
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in shapes.items():
            q, k, v = kc.flash_inputs(spec, dtype, gen, dev)
            B, Lq, Lk, d = spec[:4]
            qh, kh, vh = (kc.heads_layout(t) for t in (q, k, v))
            nbytes, flops, exps = kc.flash_work(q, k, v)
            t = bench.ms(lambda: ops.flash_attention(q, k, v))
            more = {}
            if bench.cuda:
                out = torch.empty_like(q)
                more = dict(tflops=flops / t / 1e9, heads_ms=bench.ms(
                    lambda: ops.multi_head_attention(qh, kh, vh, B)),
                    row_groups=attn_ops.flash_launch_geometry(B, Lq, Lk, d, kc.dtype_name(dtype))
                    ["warps"], ms_by_row_groups={w: bench.ms(lambda: attn_ops._launch_flash(
                        q, k, v, out, 1, attn_ops.flash_launch_geometry(
                            B, Lq, Lk, d, kc.dtype_name(dtype), warps=w)))
                        for w in attn_ops.WARP_CHOICES},
                    library_ms=bench.ms(
                        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
                    launches=kc.device_kernels(lambda: ops.multi_head_attention(qh, kh, vh, B)))
            bench.emit("flash", "flash_attn", name, t,
                       (nbytes, flops, kc.flash_peak(dtype), exps), dtype, **more)
            if d not in attn_ops.INT8_FLASH_HEAD_DIMS:
                continue
            whole, alone = kc.flash_int8_work(q, k, v)
            t = bench.ms(lambda: ops.flash_attention_int8(q, k, v))
            more = {}
            if bench.cuda:
                operands = attn_ops.int8_operands(q, k, v)
                out = torch.empty_like(q)
                more = dict(
                    row_groups=attn_ops.flash_launch_geometry(B, Lq, Lk, d, "int8")["warps"],
                    kernel_ms_by_row_groups={w: bench.ms(lambda: attn_ops._launch_flash_int8(
                        operands, out, 1, attn_ops.flash_launch_geometry(
                            B, Lq, Lk, d, "int8", warps=w)))
                        for w in attn_ops.WARP_CHOICES},
                    kernel_ms=bench.ms(lambda: attn_ops._flash_int8_cuda(q, k, v, operands)),
                    kernel_bound_ms=kc.bound(alone[0], alone[1], torch.int8, alone[2])[0],
                    quantize_ms=bench.ms(lambda: attn_ops.flash_int8_quantize(qh, kh, vh, B)),
                    heads_ms=bench.ms(lambda: ops.multi_head_attention(qh, kh, vh, B, int8=True)),
                    launches=kc.device_kernels(
                        lambda: ops.multi_head_attention(qh, kh, vh, B, int8=True)))
            bench.emit("flash", "flash_int8", name, t,
                       (whole[0], whole[1], torch.int8, whole[2]), dtype, **more)


def run_split(bench, shapes):
    """MSDA at the given shapes: bare gather of the rows it reads, gather
    with the blend, and the whole kernel, from the same indices and weights.
    The bare gather writes every gathered row (four per tap), which the
    kernel never does, so its bound is that write."""
    for name, spec in shapes.items():
        (value, ref, off, attn), lv = kc.msda_inputs(spec, torch.float32, bench.gen, bench.dev)
        table, idx, w = kc.msda_gather_operands(value, ref, off, attn, lv)
        flat = idx.reshape(idx.shape[0], -1)
        whole = bench.ms(lambda: ops.multi_scale_deformable_attn(value, ref, off, attn, lv))
        blend = bench.ms(lambda: ops.gather_blend(table, idx, w))
        gather = bench.ms(lambda: ops.gather_rows(table, flat))
        library = bench.ms(kc.gather_blend_library(table, idx, w), 3, 3)
        nbytes, flops, _ = kc.msda_work(value, ref, off, attn, lv)
        key = "ms" if bench.cuda else "cpu_ms"
        more = {f"gather_blend_{key}": blend, f"gather_rows_{key}": gather,
                f"gather_blend_library_{key}": library,
                "gather_blend_share_of_kernel": blend / whole}
        if bench.cuda:
            more["gather_blend_bound_ms"] = kc.bound(*kc.gather_blend_work(table, idx),
                                                     torch.float32)[0]
            more["gather_rows_bound_ms"] = kc.bound(*kc.gather_rows_work(table, flat),
                                                    torch.float32)[0]
        bench.emit("split", "msda", name, whole, (nbytes, flops, torch.float32), torch.float32,
                   **more)
        del value, ref, off, attn, table, idx, w, flat
        if bench.cuda:
            torch.cuda.empty_cache()


def run_dcn_split(bench, shapes, kinds):
    """The fused DCN kernel in parts, per shape, operand kind and tile
    configuration: whole (`ms`), without its corner loads (`no_loads_ms`),
    without its product (`no_product_ms`), from a gather table made ahead;
    `op_ms` is the op as the models call it (table and kernel; for a float32
    map the op's own route), `route_ms` the parent's (im2col kernel, then the
    product)."""
    dev, gen = bench.dev, bench.gen
    for name, spec in shapes.items():
        N, Cin, H, W, Cout, stride, dg = spec[:7]
        groups = spec[9]
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        for kind in kinds:
            dtype, int8 = DCN_KINDS[kind]
            x, off, mask, weight, geo = kc.dcn_inputs(spec, dtype, gen, dev)
            esz = x.element_size()
            quant = "int8" if int8 else False
            chg = dcn_ops.dcn_ch_group(Cin) if int8 else None
            # the op as the model calls it (a float32 map: the im2col route), the
            # fused kernel's weight matrix kept
            wmat = dcn_ops.dcn_weight_matrix(weight, dtype) if int8 or dtype != torch.float32 \
                else None
            op_ms = bench.ms(lambda: ops.modulated_deform_conv2d(
                x, off, mask, weight, None, groups=groups, quant=quant, wmat=wmat, **geo))
            if not bench.cuda:  # the rehearsal: the op's plain version alone
                bench.emit("dcn_split", "dcn_op", name, op_ms, None, dtype, kind=kind)
                continue
            scale_bytes = Cin // (chg or Cin) * N * 4 if int8 else 0
            work = (*kc.dcn_op_work(spec, esz, scale_bytes), dtype)
            _, launch = dcn_ops.fused_launcher(x, off, mask, weight, None, stride, 1, 1, groups,
                                               dg, "NCHW", int8, dcn_ops.dcn_weight_matrix(
                                                   weight, dtype))
            table_ms = bench.ms(lambda: dcn_ops.dcn_gather_table(x, "NCHW", chg))
            if int8:
                route_ms = bench.ms(lambda: dcn_ops.col_product(dcn_ops.deform_im2col_int8(
                    *dcn_ops.quantize_dcn_table(x, chg), off, mask, (3, 3), **geo), weight,
                    None, Ho, Wo, "NCHW"))
            else:
                route_ms = bench.ms(lambda: dcn_ops.col_product(
                    dcn_ops.deform_im2col(x, off, mask, (3, 3), **geo), weight, None, Ho, Wo,
                    "NCHW", groups))
            wd = weight.to(dtype)
            conv2d_ms = bench.ms(lambda: torch.nn.functional.conv2d(x, wd, None, stride, 1, 1,
                                                                    groups))
            flops = work[1]
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            picked = dcn_ops.dcn_config(Cout // groups, dtype, groups, N * Ho * Wo, sms)
            for config, (cdtype, *_rest) in dcn_ops.DCN_CONFIGS.items():
                if cdtype != dtype:
                    continue
                t = bench.ms(lambda: launch(config))
                bench.emit("dcn_split", "dcn_fused", name, t, work, dtype, kind=kind,
                           config=config, picked=config == picked, tflops=flops / t / 1e9,
                           no_loads_ms=bench.ms(lambda: launch(config, 1)),
                           no_product_ms=bench.ms(lambda: launch(config, 2)),
                           blocks_per_sm=dcn_ops.dcn_blocks_per_sm(config, int8),
                           table_ms=table_ms, op_ms=op_ms, route_ms=route_ms,
                           conv2d_ms=conv2d_ms)
            del x, off, mask, weight, wd, launch, wmat
            torch.cuda.empty_cache()


# the operators' calls a frame makes (chip_smoke.py's launch counts; the DCN
# op is one call for its gather table and fused kernel)
DISPATCH_FRAMES = {
    "tiny bfloat16": dict(msda=12, flash=6),
    "tiny int8": dict(msda=3, msda_int8=9, flash_int8=6, int8_gemm=202),
    "base bfloat16": dict(msda=18, flash=6, dcn=26),
    "base int8": dict(msda=6, msda_int8=12, flash_int8=6, int8_gemm=288, dcn_int8=26),
}


def layer_us(fns, synced, n=20, rounds=15):
    """{layer: [us a call of each round]}: each round times `n` calls of
    every layer in turn, the first layer rotating.  Issued (`synced`
    False): host time of the calls made while the card sleeps (~40 ms,
    past the calls' launches; none waits for it).  Synced: every call
    followed by a synchronise."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names, out = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            if not synced:
                torch.cuda._sleep(4 * kc.SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(n):
                fns[k]()
                if synced:
                    torch.cuda.synchronize()
            out[k].append((time.perf_counter() - t0) * 1e6 / n)
            torch.cuda.synchronize()
    return out


def dispatch_cases(bench):
    """{name: (shape, launch function, operator, wrapper)}, float32 inputs."""
    dev, gen, f32 = bench.dev, bench.gen, torch.float32
    cases = {}
    spec = kc.MSDA_SHAPES["sca"]
    (v, r, o, a), lv = kc.msda_inputs(spec, f32, gen, dev)
    flat = msda_ops._flat(lv)
    for name, int8 in (("msda", False), ("msda_int8", True)):
        wrapper = (msda_ops.multi_scale_deformable_attn_int8 if int8
                   else msda_ops.multi_scale_deformable_attn)
        cases[name] = ("sca tiny", lambda int8=int8: msda_ops._msda_cuda(
            v, r, o, a, lv, int8_table=True if int8 else None),
            lambda int8=int8: msda_ops.msda_op(v, r, o, a, flat, int8),
            lambda wrapper=wrapper: wrapper(v, r, o, a, lv))
    q, k, vv = kc.flash_inputs(kc.FLASH_SHAPES["decoder"], f32, gen, dev)
    cases["flash"] = ("decoder", lambda: attn_ops._flash_cuda(q, k, vv, 1),
                      lambda: attn_ops.flash_op(q, k, vv, 1),
                      lambda: ops.flash_attention(q, k, vv))
    cases["flash_int8"] = ("decoder", lambda: attn_ops._flash_int8_cuda(q, k, vv, None, 1),
                           lambda: attn_ops.flash_int8_op(q, k, vv, 1),
                           lambda: ops.flash_attention_int8(q, k, vv))
    x, w, xs, ws = kc.gemm_case(*kc.GEMM_SHAPES["dense_decoder"], gen, dev)
    cases["int8_gemm"] = ("dense_decoder", lambda: int8_ops._int8_matmul_cuda(x, w, xs, ws, f32),
                          lambda: int8_ops.int8_matmul_op(x, w, xs, ws, f32),
                          lambda: int8_ops.int8_matmul(x, w, xs, ws))
    for name, dtype, int8 in (("dcn", torch.bfloat16, False), ("dcn_int8", f32, True)):
        xd, off, mask, weight, _ = kc.dcn_inputs(kc.DCN_SHAPES["base_s3"], dtype, gen, dev)
        wmat = dcn_ops.dcn_weight_matrix(weight, dtype)
        args = (xd, off, mask, weight, None, wmat, 1, 1, 1, 1, 1, "NCHW", int8)
        cases[name] = ("base_s3", lambda args=args: dcn_ops._dcn_op_cuda(*args),
                       lambda args=args: dcn_ops.dcn_op(*args),
                       lambda args=args: dcn_ops._dcn_cuda(*args[:5], *args[6:], wmat=args[5]))
    return cases


def run_dispatch(bench):
    """The host's cost of a call at each layer of each registered operator
    (median and least of the rounds), then what the operators add to a
    frame's host time (by the medians)."""
    added = {}
    for name, (shape, launch, op, wrapper) in dispatch_cases(bench).items():
        fns = dict(launch=launch, operator=op, wrapper=wrapper)
        row = {}
        for mode in ("issue", "synced"):
            runs = layer_us(fns, mode == "synced")
            for k, t in runs.items():
                row[f"{k}_{mode}_us"], row[f"{k}_{mode}_min_us"] = float(np.median(t)), min(t)
            row[f"operator_added_{mode}_us"] = row[f"operator_{mode}_us"] - row[f"launch_{mode}_us"]
            row[f"operator_added_{mode}_min_us"] = (row[f"operator_{mode}_min_us"]
                                                    - row[f"launch_{mode}_min_us"])
        added[name] = row["operator_added_issue_us"]
        bench.emit("dispatch", name, shape, None, None, torch.float32, **row)
    for frame, calls in DISPATCH_FRAMES.items():
        bench.emit("dispatch", "frame", frame, None, calls=calls,
                   calls_per_frame=sum(calls.values()),
                   operator_added_ms=sum(n * added[k] for k, n in calls.items()) / 1e3)


def build_report():
    """Each source compiled again on its own: seconds of nvcc, and ptxas'
    registers and spills per kernel."""
    report = {}
    for name in _cuda.KERNELS:
        t0 = time.perf_counter()
        log = _cuda.build((name,), verbose=True, force=True)[name]
        lines = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        report[name] = {"nvcc_s": time.perf_counter() - t0, "ptxas": lines}
        print(json.dumps({"part": "build", "source": f"csrc/{name}.cu", **report[name]}),
              flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--span", type=int, nargs="*", default=None,
                    help="panel spans of the sweep; default: each probe shape's own")
    ap.add_argument("--shapes", nargs="*", default=None, choices=tuple(kc.PROBE_SHAPES),
                    help="probe shapes; default: all")
    ap.add_argument("--parts", nargs="*", default=DEFAULT_PARTS, choices=PARTS,
                    help="default: probes production split")
    ap.add_argument("--dcn-shapes", nargs="*", default=None, choices=tuple(kc.DCN_SHAPES),
                    help="shapes of the dcn_split part; default: base's and small's")
    ap.add_argument("--dcn-kinds", nargs="*", default=tuple(DCN_KINDS), choices=tuple(DCN_KINDS),
                    help="operand kinds of the dcn_split part")
    ap.add_argument("--build-report", action="store_true")
    ap.add_argument("--out", help="also write every row as JSON to this file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        probe_shapes = {n: kc.PROBE_SHAPES[n] for n in (args.shapes or kc.PROBE_SHAPES)}
        production = dict(msda=kc.MSDA_SHAPES, flash=kc.FLASH_SHAPES, dcn=kc.DCN_INT8_SHAPES,
                          gemm=kc.GEMM_SHAPES)
        split = {n: kc.MSDA_SHAPES[n] for n in ("base4", "sca")}
        dcn_split = {n: kc.DCN_SHAPES[n] for n in (args.dcn_shapes or kc.DCN_MODEL_SHAPES)}
    else:
        if args.build_report:
            raise SystemExit("kernel_bench: --build-report needs nvcc and a CUDA device")
        if "dispatch" in args.parts:
            raise SystemExit("kernel_bench: the dispatch part times CUDA launches")
        card = "cpu (rehearsal at toy shapes: plain versions, host times)"
        probe_shapes = kc.TOY_SHAPES["probe"]
        production = {k: kc.TOY_SHAPES[k] for k in ("msda", "flash", "dcn", "gemm")}
        split = kc.TOY_SHAPES["msda"]
        dcn_split = kc.TOY_SHAPES["dcn"]
    print(card, flush=True)
    bench = Bench(dev, rows)
    report = build_report() if args.build_report else None
    with torch.inference_mode():
        if "probes" in args.parts:
            run_probes(bench, probe_shapes, args.span)
        if "production" in args.parts:
            run_production(bench, production)
        if "split" in args.parts:
            run_split(bench, split)
        if "dcn_split" in args.parts:
            run_dcn_split(bench, dcn_split, args.dcn_kinds)
        if "flash" in args.parts:
            run_flash(bench, production["flash"])
        if "dispatch" in args.parts:
            run_dispatch(bench)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, rows=rows, build=report), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
