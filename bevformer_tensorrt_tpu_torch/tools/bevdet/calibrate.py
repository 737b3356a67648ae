"""Calibrate a quantized BEVDet on nuScenes-layout frames (port of
`tools/bevdet/calibrate.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.bevdet.calibrate --infos <infos.pkl>
        --out scales.npz [--model r50] [--data-root DIR] [--checkpoint upstream.pth]
        [--length 300] [--method entropy] [--percentile 99.99] [--ranks-pad 400000]
        [--exclude PATTERN ...] [--device cuda]

The QDQ tier (`quant=True`, every site) of the weights (`--checkpoint`, an
upstream-layout state_dict, or seeded from `--seed`) runs the two stats
passes over the first `--length` frames of the loader, with the pooling
ranks of the first frame's rig (the `scatter` splat, as the JAX tool), and
the scales of `--method` are written as a `CalibrationResult` `.npz` with
the policy (`--exclude`, default none) as its `.policy.json` sidecar.
`tools/bevdet/evaluate.py --quant-scales ... --quant int8` folds the int8
weights from them.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

from ...runtime.bevdet_engine import BEVDetEngine, rig_ranks
from ...runtime.engine import resolve_device
from ..calibrate import save_result
from .evaluate import MODELS, checkpoint_state_dict, frames_of, make_config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r50", choices=MODELS)
    ap.add_argument("--infos", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--length", type=int, default=300, help="calibration frames")
    ap.add_argument("--method", default="entropy", choices=("max", "percentile", "entropy"))
    ap.add_argument("--percentile", type=float, default=99.99)
    ap.add_argument("--ranks-pad", type=int, default=400000)
    ap.add_argument("--exclude", nargs="*", action="extend", default=None,
                    help="policy patterns written beside the scales (default: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        args.out += ".npz"

    device = resolve_device(args.device)
    cfg = make_config(args.model, quant=True)
    frames = frames_of(cfg, args.infos, args.data_root)
    ranks = rig_ranks(cfg, frames.infos[0], args.ranks_pad, intervals=False)
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVDetEngine(cfg, ranks, state_dict=state_dict, device=device, seed=args.seed,
                          pool_impl="scatter")
    n = min(args.length, len(frames))
    images = [frames.frame(i).image for i in range(n)]
    result = engine.calibrate(images, method=args.method, percentile=args.percentile)
    exclude = tuple(args.exclude or ())
    save_result(result, args.out, exclude, model=f"bevdet-{args.model}", frames=n,
                infos=args.infos)
    print(f"saved {len(result.scales)} scales ({args.method}, {n} frames of bevdet-{args.model}) "
          f"-> {args.out}; policy {list(exclude)}")
    return result


if __name__ == "__main__":
    main()
