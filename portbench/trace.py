"""The traced run: `torch.profiler` over the window, kept in memory and
reduced here to a summary.  No trace file is written.

Ranges: the benchmark opens a `record_function` range when a module's
forward begins (a forward pre-hook) and closes it when another's ends (a
forward hook): `backbone` over `img_backbone` and `img_neck`, `encoder`
over the transformer's encoder, `decoder` from the decoder's start to the
end of the head (its branches).  The harness's own spans (`infer_frame`,
`readback`, `step`, `bookkeeping`) and the window are ranges too.

A device operation (kernel, copy, fill) belongs to a range when the host
call that launched it started inside the range: the CUDA runtime call that
started it (the same correlation id), or else the innermost host operation
that the profiler links it to.  An
operator's device time (`bevformer_port::msda`, ...) is that of the device
operations launched inside its calls.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

PREFIX = "portbench::"
RANGES = {  # name: (module whose forward opens it, module whose forward closes it)
    "backbone": ("img_backbone", "img_neck"),
    "encoder": ("pts_bbox_head.transformer.encoder", "pts_bbox_head.transformer.encoder"),
    "decoder": ("pts_bbox_head.transformer.decoder", "pts_bbox_head"),
}
OPERATORS = ("bevformer_port::msda", "bevformer_port::modulated_deform_conv2d",
             "bevformer_port::flash_attention")
TOP = 10
RUNTIME = re.compile(r"cu[A-Z]|cuda[A-Z]")


def span(name: str):
    """A host range of the benchmark's own, in the trace when one runs."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def module_ranges(model):
    """The ranges of RANGES on `model`'s forwards, for the block."""
    hooks, open_ = [], {}

    def opener(name):
        def pre(mod, args):
            open_[name] = torch.profiler.record_function(PREFIX + name)
            open_[name].__enter__()
        return pre

    def closer(name):
        def post(mod, args, out):
            rf = open_.pop(name, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        return post

    for name, (first, last) in RANGES.items():
        hooks.append(model.get_submodule(first).register_forward_pre_hook(opener(name)))
        hooks.append(model.get_submodule(last).register_forward_hook(closer(name)))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, gaps [(start, end)]) of sorted [start, end] rows."""
    covered, gaps, end = 0, [], None
    for s, e in intervals:
        if end is None:
            covered, end = e - s, e
        elif s > end:
            gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


HARNESS_SPANS = ("infer_frame", "readback", "step", "bookkeeping")


def summarize(prof) -> dict:
    """busy_s, window_s, the device seconds of each range and operator, and
    the breakdown (top device operations; idle time by host activity)."""
    events = prof.profiler.kineto_results.events()
    cpu_dev = torch.autograd.DeviceType.CPU
    host: List[Tuple[int, int, str]] = []
    dev_s, dev_e, dev_corr, dev_link, dev_name = [], [], [], [], []
    runtime_start, op_start = {}, {}
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == cpu_dev:
            host.append((s, s + e.duration_ns(), name))
            # CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel)
            # share their correlation id with the device operation they start
            starts = runtime_start if RUNTIME.match(name) else op_start
            starts[e.correlation_id()] = s
        elif not name.startswith(PREFIX):
            dev_s.append(s)
            dev_e.append(s + e.duration_ns())
            dev_corr.append(e.correlation_id())
            dev_link.append(e.linked_correlation_id())
            dev_name.append(name)
    window = [h for h in host if h[2] == PREFIX + "window"]
    if not window or not dev_s:
        return {}
    w0, w1 = window[0][0], window[0][1]
    ds = np.clip(np.array(dev_s, np.int64), w0, w1)
    de = np.clip(np.array(dev_e, np.int64), w0, w1)
    keep = de > ds
    ds, de = ds[keep], de[keep]
    names = [n for n, k in zip(dev_name, keep) if k]
    # a device operation's launch: its runtime call, else the host operation
    # the profiler links it to
    launched = np.array([runtime_start.get(c, op_start.get(link, -1))
                         for c, link, k in zip(dev_corr, dev_link, keep) if k], np.int64)
    dur = (de - ds) / 1e9

    spans: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    grouped: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for s, e, name in host:
        if name.startswith(PREFIX) or name in OPERATORS:
            grouped[name.removeprefix(PREFIX)].append((s, e))
    for name, v in grouped.items():
        a = np.array(sorted(v), np.int64)
        spans[name] = (a[:, 0], a[:, 1])

    def inside(name, t):
        starts, ends = spans[name]
        i = np.searchsorted(starts, t, side="right") - 1
        return (i >= 0) & (t <= ends[np.maximum(i, 0)])

    range_s = {name: float(dur[inside(name, launched) & (launched >= 0)].sum())
               for name in spans if name != "window"}
    by_name: Dict[str, float] = defaultdict(float)
    for n, d in zip(names, dur):
        by_name[n] += d
    order = np.argsort(ds, kind="stable")
    covered, gaps = _union(np.stack([ds[order], de[order]], axis=1).tolist())

    # every idle gap, named by the benchmark's span and the innermost host
    # call open at the gap's middle (the parent of each host event is found
    # once, in order of start)
    host.sort()
    starts = np.array([h[0] for h in host], np.int64)
    parent, open_ = [], []
    for i, (s, e, _) in enumerate(host):
        while open_ and host[open_[-1]][1] < s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        while j >= 0 and (host[j][1] < mid or host[j][2].startswith(PREFIX)):
            j = parent[j]
        call = host[j][2] if j >= 0 else "python"
        where = next((n for n in HARNESS_SPANS if n in spans and inside(n, mid)), "harness")
        idle[f"{where}: {call}"] += (g1 - g0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa
    return {"busy_s": covered / 1e9, "window_s": (w1 - w0) / 1e9, "ranges": range_s,
            "unlinked_s": float(dur[launched < 0].sum()), "device_s": float(dur.sum()),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}
