"""Calibrate a quantized BEVFormer on seeded synthetic frames.

    python -m bevformer_tensorrt_tpu_torch.tools.calibrate --out scales.npz
        [--model tiny] [--frames 4] [--method entropy] [--percentile 99.99]
        [--exclude PATTERN ...] [--seed 0] [--device cuda]

Builds the model's QDQ tier (`quant=True`) with seeded weights, runs the two
stats passes over N frames of one synthetic scene (`runtime/synthetic.py`),
chooses the scales and writes them as a `CalibrationResult` `.npz`, with the
mixed-precision policy (`--exclude`, default: the int8 default of the
config) as a `.policy.json` sidecar beside it.  An engine of the same
weights under `quant="int8"` takes them through
`quant.fold.attach_quant_scales(engine.model, result.scales)`.

Calibration on nuScenes frames through the data loader (the JAX package's
`tools/bevformer/calibrate.py`) waits for the port of the data and
evaluation modules; this tool has no dataset to read.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import bevformer as configs
from ..quant.policy import save_policy
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import synthetic_frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--model", default="tiny", choices=("micro", "tiny", "small", "base"))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--method", default="entropy", choices=("max", "percentile", "entropy"))
    ap.add_argument("--percentile", type=float, default=99.99)
    ap.add_argument("--exclude", nargs="*", default=None,
                    help="policy patterns; default: the config's int8 default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    make = getattr(configs, f"bevformer_{args.model}")
    exclude = (make(quant="int8").quant_exclude if args.exclude is None
               else tuple(args.exclude))
    cfg = make(quant=True, quant_exclude=exclude)
    engine = BEVFormerEngine(cfg, seed=args.seed, device=args.device)
    frames = synthetic_frames(cfg, np.random.default_rng(args.seed), ["scene"] * args.frames)
    result = engine.calibrate(frames, method=args.method, percentile=args.percentile)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    result.save(out)
    save_policy(out, exclude, model=args.model, method=args.method, frames=args.frames,
                seed=args.seed)
    print(f"{len(result.scales)} sites calibrated ({args.method}, {args.frames} frames of "
          f"{args.model}) -> {out}; policy {list(exclude)}")


if __name__ == "__main__":
    main()
