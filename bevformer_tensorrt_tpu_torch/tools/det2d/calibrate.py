"""Calibrate a quantized YOLOX or CenterNet on a COCO-format set (port of
`tools/2d/calibrate.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.det2d.calibrate <model> --ann <instances.json>
        --img-root DIR --out scales.npz [--checkpoint upstream.pth] [--length 512]
        [--batch 8] [--method percentile] [--percentile 99.99] [--exclude PATTERN ...]
        [--seed 0] [--device cuda]

The QDQ tier (`quant=True`, every site) of the weights (`--checkpoint`, an
upstream-layout state_dict, or seeded from `--seed`) runs the two stats
passes over the first `--length` images of the loader in batches of
`--batch` (a short last batch padded with zero images, as the JAX tool's),
and the scales of `--method` are written as a `CalibrationResult` `.npz`
with the policy (`--exclude`, default none) as its `.policy.json` sidecar.
`tools/det2d/evaluate.py --quant-scales` reads both and folds the int8
weights from its own checkpoint's weights.  Runs on CUDA unless `--device
cpu` is given.
"""
from __future__ import annotations

import argparse

from ...runtime.det2d_engine import MODELS, Det2DEngine, load_checkpoint_state_dict, make_config
from ...runtime.engine import resolve_device
from ...runtime.torch_import import load_torch_checkpoint
from ..calibrate import save_result
from .evaluate import batch_images, dataset_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--length", type=int, default=512, help="calibration images")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--method", default="percentile", choices=("max", "percentile", "entropy"),
                    help="percentile 99.99 is the reference's QDQ default (entropy collapses "
                         "long-tailed head activations)")
    ap.add_argument("--percentile", type=float, default=99.99)
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
    ds = dataset_of(args.model, cfg, args.ann, args.img_root)
    state_dict = (load_checkpoint_state_dict(cfg, load_torch_checkpoint(args.checkpoint))
                  if args.checkpoint else None)
    engine = Det2DEngine(cfg, state_dict=state_dict, device=device, seed=args.seed)
    n = min(args.length, len(ds))
    batches = [batch_images([ds.sample(i) for i in range(s, min(s + args.batch, n))],
                            args.batch, cfg.img_size) for s in range(0, n, args.batch)]
    result = engine.calibrate(batches, method=args.method, percentile=args.percentile)
    exclude = tuple(args.exclude or ())
    save_result(result, args.out, exclude, model=args.model, images=n, ann=args.ann)
    print(f"saved {len(result.scales)} scales ({args.method}, {n} images of {args.model}) "
          f"-> {args.out}; policy {list(exclude)}")
    return result


if __name__ == "__main__":
    main()
