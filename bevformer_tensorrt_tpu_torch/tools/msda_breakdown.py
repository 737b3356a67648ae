"""Where an MSDA call's time goes, stage by stage (port of `tools/msda_breakdown.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.msda_breakdown [temporal|cross] [--dtype bfloat16]
        [--int8] [--iters 20] [--device cpu] [--toy]

At base's temporal self-attention (2 x 40000 queries, one 200x200 level, 4
points) or spatial cross-attention (6 cameras x 14080 compacted queries, four
levels, 8 points, 4 anchors) shapes, with the JAX tool's row-major reference
walk and 2-pixel offsets, times the stages the port's call has:

  table     the value table: `ops/msda.py::quantize_value_table` for the
            int8 table (`--int8`), the cast to the compute dtype otherwise
  geometry  the launch geometry on the host (`msda_launch_geometry`)
  launch    the kernel alone on a table made ahead (`_msda_cuda`)
  op        the public op (`multi_scale_deformable_attn[_int8]`): the
            registered operator, `with_plain_vjp`'s autograd Function and
            the table; `op - launch - table` is what they add on the card
  host      the host's microseconds to issue one launch and one op call,
            timed while the card is held busy (a device sleep queued
            first): what the operator and the Function add on the host,
            which the device times cannot see

The JAX tool's stages (its bf16-pair table build, the tap preparation and
the panel-sorted kernel in one or two corner groups) have no counterpart:
the port's kernel reads the value where it lies.  Timing: CUDA events, the
median over repeats (`kernel_cases.device_ms`; the geometry on the host
clock).  On the CPU (`--device cpu`) `launch` is the plain version and the
times are the host clock (a rehearsal); `--toy` cuts the shapes.  Runs on
CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import msda
from ..runtime.engine import resolve_device
from .accuracy_cycle import device_name
from .kernel_cases import SLEEP_CYCLES, call_ms

SHAPES = {
    # which: (bs, heads, ch, P, ppg, shapes, nq)
    "temporal": (2, 8, 32, 4, 1, ((200, 200),), 40000),
    "cross": (6, 8, 32, 8, 4, ((116, 200), (58, 100), (29, 50), (15, 25)), 14080),
}
TOY = {"temporal": (2, 8, 32, 4, 1, ((10, 10),), 100),
       "cross": (6, 8, 32, 8, 4, ((8, 12), (4, 6), (2, 3), (1, 2)), 64)}


def inputs(which: str, dtype, dev, toy: bool = False):
    """value [bs, keys, heads, ch] in `dtype`, ref, offsets and logits: the
    JAX tool's draws (seed 0), a row-major walk over the first level."""
    bs, heads, ch, P, ppg, shapes, nq = (TOY if toy else SHAPES)[which]
    rng = np.random.default_rng(0)
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = rng.standard_normal((bs, keys, heads, ch)).astype(np.float32)
    t = np.linspace(0, 1, nq, endpoint=False)
    H0, W0 = shapes[0]
    ys = (np.floor(t * H0) + 0.5) / H0
    xs = (t * H0 % 1.0) + 0.5 / W0
    ref = np.tile(np.stack([xs, ys], -1)[None, :, None, :], (bs, 1, 1, ppg)).astype(np.float32)
    off = (rng.standard_normal((bs, nq, heads, L * P * 2)) * 2.0).astype(np.float32)
    attn = rng.standard_normal((bs, nq, heads, L * P)).astype(np.float32)
    f = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return f(value).to(dtype), f(ref), f(off).to(dtype), f(attn).to(dtype), shapes


def issue_us(fn, dev, n: int = 50) -> float:
    """Host microseconds to issue one call of `fn`, the card held busy by a
    device sleep queued first (on the CPU: the call's host time)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(SLEEP_CYCLES * 5)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return us


def breakdown(which: str, dtype, int8: bool, dev, iters: int, toy: bool = False) -> dict:
    value, ref, off, attn, shapes = inputs(which, dtype, dev, toy)
    bs, keys, heads, ch = value.shape
    L, P = len(shapes), attn.shape[-1] // len(shapes)
    op = msda.multi_scale_deformable_attn_int8 if int8 else msda.multi_scale_deformable_attn
    if int8:
        table_fn = lambda: msda.quantize_value_table(value)  # noqa: E731
    else:
        table_fn = lambda: value.to(dtype).contiguous()  # noqa: E731
    table = table_fn()
    t0 = time.perf_counter()
    for _ in range(100):
        msda.msda_launch_geometry(bs, ref.shape[1], heads, ch, L, P,
                                  1 if int8 else value.element_size(), value.data_ptr())
    geometry_ms = (time.perf_counter() - t0) * 10.0
    if dev.type == "cuda":
        launch = lambda: msda._msda_cuda(value, ref, off, attn, shapes,  # noqa: E731
                                         int8_table=table if int8 else None)
    else:
        plain = msda.multi_scale_deformable_attn_int8_plain if int8 else \
            msda.multi_scale_deformable_attn_plain
        launch = lambda: plain(value, ref, off, attn, shapes)  # noqa: E731
    rec = {"which": which, "dtype": str(dtype).split(".")[-1], "int8": int8,
           "table_ms": call_ms(table_fn, dev, n=iters),
           "geometry_ms": geometry_ms,
           "launch_ms": call_ms(launch, dev, n=iters),
           "op_ms": call_ms(lambda: op(value, ref, off, attn, shapes), dev, n=iters)}
    rec["op_overhead_ms"] = rec["op_ms"] - rec["launch_ms"] - (rec["table_ms"] if int8 else 0.0)
    n = 50 if dev.type == "cuda" else 1
    rec["launch_host_us"] = issue_us(launch, dev, n)
    rec["op_host_us"] = issue_us(lambda: op(value, ref, off, attn, shapes), dev, n)
    taps = bs * ref.shape[1] * heads * L * P
    rec["mtaps_per_s"] = taps / (rec["launch_ms"] / 1e3) / 1e6
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="temporal", choices=tuple(SHAPES))
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--int8", action="store_true", help="the int8 value table")
    ap.add_argument("--iters", type=int, default=20, help="calls a timed batch")
    ap.add_argument("--toy", action="store_true", help="small stand-ins (a rehearsal)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with torch.inference_mode():
        rec = breakdown(args.which, getattr(torch, args.dtype), args.int8, dev, args.iters,
                        args.toy)
    rec["device"] = device_name(dev)
    for k in ("table", "geometry", "launch", "op", "op_overhead"):
        print(f"{args.which}: {k} {rec[f'{k}_ms']:.4f} ms", flush=True)
    print(f"{args.which}: host issue: launch {rec['launch_host_us']:.1f} us, op "
          f"{rec['op_host_us']:.1f} us", flush=True)
    print(rec["device"])
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
