"""Export a deployable BEVFormer artifact, the ".trt engine build" step
(port of `tools/bevformer/export.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.export base --out DIR
        [--checkpoint upstream.pth] [--quant-scales scales.npz [--quant int8|qdq]]
        [--dtype bfloat16] [--aot] [--device cuda]

Writes the directory `--out`:

  model.pt2   `BEVFormer.forward(image, prev_bev, use_prev_bev, can_bus,
              lidar2img)` as a `torch.export` program with its weights (and
              the folded int8 weights), each kernel a registered operator
  meta.json   model, dtype, quant, the input shapes, the device

`runtime/export.py::load_program(DIR)` reloads it; the caller keeps prev_bev
and the can_bus deltas (`runtime/engine.py::TemporalState`).  The example
inputs are the JAX tool's (zeros, use_prev_bev 1).  `--checkpoint` is an
upstream-layout state_dict; without it the weights are seeded.
`--quant-scales` is a `CalibrationResult` `.npz` of `tools/calibrate.py`
with its `.policy.json`; the int8 weights are folded from this checkpoint's
weights.  `--aot` builds the kernels' libraries for the card first
(`ops._cuda.build`).  Export on the device the program will run on: CUDA
unless `--device cpu` is given.  The last line of stdout is one JSON object
{out, artifacts (bytes a file), artifact_mb}.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..configs import bevformer as configs
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..quant.policy import load_policy
from ..runtime.engine import BEVFormerEngine, resolve_device
from ..runtime.export import artifact_summary, export_program
from .evaluate import MODELS, checkpoint_state_dict

LEFT_OUT = ("Not ported from the JAX CLI: --autotune, --autotune-iters (the Mosaic kernel-layout "
            "search; the port's kernels pick their geometry by rule).")


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


def attach_scales(model, args) -> None:
    if args.quant_scales:  # folds the int8 weights from this checkpoint's weights
        attach_quant_scales(model, CalibrationResult.load(args.quant_scales).scales)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], epilog=LEFT_OUT)
    ap.add_argument("model", choices=MODELS)
    quant_args(ap, "bfloat16")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
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
    export_program(engine.model, example, args.out, {
        "model": args.model, "dtype": args.dtype,
        "quant": args.quant if args.quant_scales else "none",
        "image": list(example[0].shape), "prev_bev": list(example[1].shape),
        "lidar2img": list(example[4].shape)})
    line = artifact_summary(args.out)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
