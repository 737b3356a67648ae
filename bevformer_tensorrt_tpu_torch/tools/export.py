"""Export a deployable BEVFormer artifact, the ".trt engine build" step
(port of `tools/bevformer/export.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.export base --out DIR
        [--checkpoint upstream.pth] [--quant-scales scales.npz [--quant int8|qdq]]
        [--dtype bfloat16] [--aot] [--autotune [--autotune-iters 5]] [--device cuda]

Writes the directory `--out`:

  model.pt2   `BEVFormer.forward(image, prev_bev, use_prev_bev, can_bus,
              lidar2img)` as a `torch.export` program with its weights (and
              the folded int8 weights), each kernel a registered operator
  meta.json   model, dtype, quant, the input shapes, the device
  knobs.json  with --autotune: the kernel knobs the program runs under
              (`runtime/autotune.py`), the sweep's table and its timing input

`runtime/export.py::load_program(DIR)` reloads it; the caller keeps prev_bev
and the can_bus deltas (`runtime/engine.py::TemporalState`).  The example
inputs are the JAX tool's (zeros, use_prev_bev 1).  `--checkpoint` is an
upstream-layout state_dict; without it the weights are seeded.
`--quant-scales` is a `CalibrationResult` `.npz` of `tools/calibrate.py`
with its `.policy.json`; the int8 weights are folded from this checkpoint's
weights.  `--aot` builds the kernels' libraries for the card first
(`ops._cuda.build`).  `--autotune` times one frame of the model for every
set of `runtime/autotune.py::DEFAULT_GRID` on the card (a warm-up call,
then the median of `--autotune-iters` synchronised calls), on the seeded
rig of `runtime/synthetic.py` (the second frame of a scene, its prev_bev
from the first: the example inputs' zero lidar2img would project no BEV
query into any camera), exports under the winner and writes `knobs.json`;
the winner goes to stderr.  Export on the device the program will run on:
CUDA unless `--device cpu` is given.  The last line of stdout is one JSON
object {out, artifacts (bytes a file), artifact_mb}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import bevformer as configs
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..quant.policy import load_policy
from ..runtime.autotune import DEFAULT_GRID, autotune, knob_set, save_knobs
from ..runtime.engine import BEVFormerEngine, resolve_device
from ..runtime.export import artifact_summary, export_program
from ..runtime.synthetic import synthetic_frames
from .evaluate import MODELS, checkpoint_state_dict

TIMING_INPUT = ("runtime/synthetic.py synthetic_frames(cfg, numpy.random.default_rng(0)): the "
                "second frame of one scene, prev_bev from the first")


def quant_args(ap: argparse.ArgumentParser, default_dtype: str) -> None:
    """The arguments the three export CLIs share."""
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--quant-scales", default=None,
                    help="CalibrationResult .npz of the family's calibrate tool, with its "
                         "policy beside it")
    ap.add_argument("--quant", default="int8", choices=("qdq", "int8"),
                    help="with --quant-scales: 'int8' runs the int8 products and kernels, "
                         "'qdq' simulates the quantization")
    ap.add_argument("--dtype", default=default_dtype, choices=("float32", "bfloat16"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--aot", action="store_true",
                    help="build the kernels' libraries for this card first")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")


def quant_config(args):
    """(quant, quant_exclude) of the parsed arguments."""
    if not args.quant_scales:
        return False, ()
    return ("int8" if args.quant == "int8" else True), load_policy(args.quant_scales)


def build_kernels(args, device) -> None:
    """`--aot`: compile every kernel's library for the card now."""
    if args.aot:
        if device.type != "cuda":
            raise ValueError("--aot builds the CUDA kernels: it needs --device cuda")
        from ..ops import _cuda

        _cuda.build()
        print("kernels built", file=sys.stderr)


def frame_seconds(module, inputs, iters: int) -> float:
    """Median seconds of `iters` calls `module(*inputs)`, each synchronised
    with the inputs' card, after one warm-up call, under no_grad."""
    device = inputs[0].device
    with torch.no_grad():
        module(*inputs)
        torch.cuda.synchronize(device)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            module(*inputs)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def sweep(engine: BEVFormerEngine, iters: int) -> dict:
    """`runtime/autotune.py::autotune` over its DEFAULT_GRID, each set timing a frame
    of the engine's module on the seeded rig (TIMING_INPUT).  Returns its
    result with the timing input, the iterations and the card's name."""
    frames = synthetic_frames(engine.cfg, np.random.default_rng(0), ("scene-0", "scene-0"))
    engine.reset()
    engine.infer_frame(**frames[0])
    inputs = engine.frame_inputs(**frames[1])
    engine.reset()

    def bench_once(knobs):
        with knob_set(knobs):
            return frame_seconds(engine.model, inputs, iters)

    result = autotune(bench_once, DEFAULT_GRID)
    return dict(result, timing_input=TIMING_INPUT, iters=iters,
                device=torch.cuda.get_device_name(engine.device))


def attach_scales(model, args) -> None:
    if args.quant_scales:  # folds the int8 weights from this checkpoint's weights
        attach_quant_scales(model, CalibrationResult.load(args.quant_scales).scales)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=MODELS)
    quant_args(ap, "bfloat16")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the kernels' launch knobs at the deploy shapes on this card, "
                         "export under the fastest set and write it to knobs.json")
    ap.add_argument("--autotune-iters", type=int, default=5,
                    help="timed frames a knob set (after a warm-up frame)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.autotune and device.type != "cuda":
        raise ValueError("--autotune times the CUDA kernels: it needs --device cuda")
    build_kernels(args, device)
    quant, exclude = quant_config(args)
    cfg = getattr(configs, f"bevformer_{args.model}")(dtype=args.dtype, quant=quant,
                                                       quant_exclude=exclude)
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVFormerEngine(cfg, state_dict=state_dict, device=device)
    attach_scales(engine.model, args)
    nq = cfg.bev_h * cfg.bev_w
    example = (torch.zeros((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), device=device),
               torch.zeros((nq, 1, cfg.embed_dims), device=device),
               torch.tensor(1.0, device=device),
               torch.zeros(cfg.can_bus_dims, device=device),
               torch.zeros((1, cfg.num_cams, 4, 4), device=device))
    tuned = None
    if args.autotune:
        tuned = sweep(engine, args.autotune_iters)
        print(f"autotune winner: {tuned['knobs']} ({tuned['seconds'] * 1e3:.2f} ms a frame on "
              f"{tuned['device']})", file=sys.stderr)
    with knob_set(tuned["knobs"] if tuned else None):
        export_program(engine.model, example, args.out, {
            "model": args.model, "dtype": args.dtype,
            "quant": args.quant if args.quant_scales else "none",
            "image": list(example[0].shape), "prev_bev": list(example[1].shape),
            "lidar2img": list(example[4].shape)})
    if tuned:
        save_knobs(args.out, tuned)
    line = artifact_summary(args.out)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
