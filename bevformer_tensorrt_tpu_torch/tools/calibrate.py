"""Calibrate a quantized BEVFormer: on nuScenes-layout frames through the
data loader, or on seeded synthetic frames.

    python -m bevformer_tensorrt_tpu_torch.tools.calibrate tiny --infos <infos.pkl>
        [--data-root DIR] [--checkpoint upstream.pth] [--length 500]
        [--method percentile] [--also-methods max,entropy] [--percentile 99.99]
        [--exclude PATTERN ...] [--save-stats stats.npz] --out scales.npz [--device cuda]
    python -m bevformer_tensorrt_tpu_torch.tools.calibrate [tiny] --out scales.npz
        [--frames 4] [--method entropy] [--percentile 99.99]
        [--exclude PATTERN ...] [--seed 0] [--device cuda]

With `--infos` (port of `tools/bevformer/calibrate.py`): a float32 engine of
the weights (`--checkpoint`, an upstream-layout state_dict, or seeded from
`--seed`) runs the first `--length` frames of the loader in order and
records what each frame gave the model: the image, lidar2img, the recurrent
prev_bev, use_prev_bev and the can_bus deltas.  The QDQ tier (`quant=True`,
every site) of the same weights then runs the two stats passes over those
inputs, and the scales of `--method` are written to `--out`, those of each
of `--also-methods` beside it as `<out>.<method>`.  As in the JAX tool,
every site gets a scale and `--exclude` (default: no pattern) is written
only to the policy.

Without `--infos`: the QDQ tier with seeded weights runs the two stats
passes over N frames of one synthetic scene (`runtime/synthetic.py`),
carrying its own temporal state; `--exclude` defaults to the config's int8
policy.

Each artifact is a `CalibrationResult` `.npz` with the mixed-precision policy
as a `.policy.json` sidecar beside it.  An engine of the same weights under
`quant="int8"` takes it through
`quant.fold.attach_quant_scales(engine.model, result.scales)`, or
`tools/evaluate.py --quant-scales`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import bevformer as configs
from ..data.nuscenes import NuScenesFrames
from ..quant.calibrate import collect_stats, scales_from_stats
from ..quant.policy import save_policy
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import synthetic_frames
from .evaluate import MODELS, checkpoint_state_dict, image_norm


@torch.inference_mode()
def float_prepass(engine: BEVFormerEngine, frames: NuScenesFrames, n: int) -> list:
    """The model's inputs for each of the first `n` frames, on the host, as
    the float32 engine's temporal state gives them."""
    engine.reset()
    batches = []
    for i in range(n):
        f = frames.frame(i)
        inputs = engine.frame_inputs(f.image, f.can_bus, f.lidar2img, f.scene_token)
        batches.append(tuple(t.cpu() for t in inputs))
        engine.state.prev_bev = engine.model(*inputs)[0]
    return batches


def save_result(result, path: str, exclude, **meta) -> None:
    with open(path, "wb") as fh:  # np.savez would append .npz to <out>.<method>
        result.save(fh)
    save_policy(path, exclude, method=result.method, **meta)


def calibrate_from_loader(args, model: str, exclude, methods) -> None:
    make = getattr(configs, f"bevformer_{model}")
    cfg = make()
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVFormerEngine(cfg, state_dict=state_dict, seed=args.seed, device=args.device)
    frames = NuScenesFrames(args.infos, args.data_root, img_norm=image_norm(model),
                            target_hw=(cfg.img_h, cfg.img_w))
    n = min(args.length, len(frames))
    print(f"pre-pass: {n} frames")
    batches = float_prepass(engine, frames, n)
    if state_dict is None:
        state_dict = {k: v.cpu() for k, v in engine.model.state_dict().items()}
    del engine

    qdq = BEVFormerEngine(make(quant=True), state_dict=state_dict, device=args.device)

    def run_batch(batch):
        with torch.inference_mode():
            qdq.model(*(t.to(qdq.device) for t in batch))

    print(f"calibration: methods={methods}")
    amax, hist = collect_stats(run_batch, qdq.model, batches, with_hist=methods != ["max"])
    if args.save_stats:
        np.savez(args.save_stats, **{f"amax/{k}": np.float32(v) for k, v in amax.items()},
                 **{f"hist/{k}": v for k, v in hist.items()})
        print(f"saved raw stats -> {args.save_stats}")
    for i, method in enumerate(methods):
        result = scales_from_stats(amax, hist, method=method, percentile=args.percentile)
        out = args.out if i == 0 else f"{args.out}.{method}"
        save_result(result, out, exclude, model=model, frames=n, infos=args.infos)
        print(f"saved {len(result.scales)} scales ({method}, {n} frames of {model}) -> {out}; "
              f"policy {list(exclude)}")


def calibrate_synthetic(args, model: str, exclude, method: str) -> None:
    cfg = getattr(configs, f"bevformer_{model}")(quant=True, quant_exclude=exclude)
    engine = BEVFormerEngine(cfg, seed=args.seed, device=args.device)
    frames = synthetic_frames(cfg, np.random.default_rng(args.seed), ["scene"] * args.frames)
    result = engine.calibrate(frames, method=method, percentile=args.percentile)
    save_result(result, args.out, exclude, model=model, frames=args.frames, seed=args.seed)
    print(f"{len(result.scales)} sites calibrated ({method}, {args.frames} frames of "
          f"{model}) -> {args.out}; policy {list(exclude)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="tiny", choices=MODELS)
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--infos", default=None, help="calibrate on these frames (loader mode)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--length", type=int, default=500, help="loader mode: calibration frames")
    ap.add_argument("--frames", type=int, default=4, help="synthetic mode: calibration frames")
    ap.add_argument("--method", default=None, choices=("max", "percentile", "entropy"),
                    help="default: percentile with --infos, else entropy")
    ap.add_argument("--also-methods", default=None,
                    help="loader mode: comma list of further methods, each written to "
                         "<out>.<method> from the same stats")
    ap.add_argument("--percentile", type=float, default=99.99)
    ap.add_argument("--exclude", nargs="*", action="extend", default=None,
                    help="policy patterns; default: none with --infos, else the config's "
                         "int8 default")
    ap.add_argument("--save-stats", default=None,
                    help="loader mode: also save each site's amax and histogram (.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    model = args.model
    if not args.out.endswith(".npz"):
        args.out += ".npz"

    if args.infos:
        exclude = () if args.exclude is None else tuple(args.exclude)
        methods = [args.method or "percentile"] + (
            [m for m in args.also_methods.split(",") if m] if args.also_methods else [])
        calibrate_from_loader(args, model, exclude, methods)
    else:
        if args.also_methods or args.save_stats or args.checkpoint:
            ap.error("--also-methods, --save-stats and --checkpoint need --infos")
        exclude = (getattr(configs, f"bevformer_{model}")(quant="int8").quant_exclude
                   if args.exclude is None else tuple(args.exclude))
        calibrate_synthetic(args, model, exclude, args.method or "entropy")


if __name__ == "__main__":
    main()
