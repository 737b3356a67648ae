"""Evaluate BEVDet on a nuScenes-layout set: NDS / mAP and FPS (port of
`tools/bevdet/evaluate.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.bevdet.evaluate --infos <infos.pkl>
        [--model r50] [--data-root DIR] [--checkpoint upstream.pth] [--dtype bfloat16]
        [--limit N] [--ranks-pad 400000] [--pool-impl interval]
        [--quant-scales scales.npz [--quant int8]] [--device cuda]

The pooling ranks are made once from the first frame's camera rig (the
reference bakes one rig's ranks into its engine).  The loader
(`data/nuscenes.py`, pytorch-style norm, the 256x704 pad or crop of the JAX
loader) feeds `BEVDetEngine`; the decode runs on the card, the Scale-NMS on
the host with the native rotated NMS.  The loop is pipelined as
`tools/evaluate.py`'s: frame t+1 is dispatched before frame t is read back
into pinned memory and post-processed.  The last line of stdout is one JSON
object of the rounded metrics with `fps` and `latency_ms` (the first and last
frames dropped).

`--checkpoint` is an upstream-layout state_dict (`.pth`); without it the
weights are seeded.  `--quant-scales` is a `.npz` of
`tools/bevdet/calibrate.py` with its `.policy.json`: 'qdq' simulates the
quantization, 'int8' runs every convolution on the int8 product (its
weights folded from the checkpoint's).  Runs on CUDA unless `--device cpu`
is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Sequence

from ...configs.bevdet import bevdet_micro, bevdet_r50
from ...data.nuscenes import IMG_NORM_PYTORCH, NuScenesFrames
from ...evalsuite import detections_to_eval_boxes, gt_to_eval_boxes
from ...models.heads.centerpoint_head import centerpoint_post_process
from ...quant.fold import attach_quant_scales
from ...quant.observers import CalibrationResult
from ...quant.policy import load_policy
from ...runtime.bevdet_engine import POOL_IMPLS, BEVDetEngine, rig_ranks
from ...runtime.engine import resolve_device
from ...runtime.torch_import import load_bevdet_checkpoint, load_torch_checkpoint
from ..evaluate import EvalResult, EvalRun, pipelined_loop

MODELS = ("r50", "micro")


def make_config(model: str, **over):
    return (bevdet_micro if model == "micro" else bevdet_r50)(**over)


def frames_of(cfg, infos: str, data_root=None) -> NuScenesFrames:
    return NuScenesFrames(infos, data_root, img_norm=IMG_NORM_PYTORCH,
                          target_hw=(cfg.input_h, cfg.input_w))


def checkpoint_state_dict(cfg, path: str):
    """The port's state_dict from an upstream-layout BEVDet checkpoint."""
    return load_bevdet_checkpoint(cfg, load_torch_checkpoint(path))


@dataclasses.dataclass
class BEVDetRun(EvalRun):
    """`EvalRun` with the host ms of each frame's Scale-NMS."""

    nms_ms: List[float] = dataclasses.field(default_factory=list)


def eval_loop(engine: BEVDetEngine, frames: NuScenesFrames, indices: Sequence[int],
              pipelined: bool = True) -> BEVDetRun:
    """The frames through the engine (decode on the device), each read back
    and post-processed on the host (`tools.evaluate.pipelined_loop`)."""
    cfg = engine.cfg
    run = BEVDetRun()

    def dispatch(f):
        return engine.readback(*engine.infer_frame(f.image))

    def finish(f, readback):
        boxes, scores, labels, valid = (t.numpy() for t in readback.result())
        t0 = time.perf_counter()
        det = centerpoint_post_process(cfg, boxes, scores, labels, valid)
        run.nms_ms.append((time.perf_counter() - t0) * 1e3)
        run.detections.append(det)
        run.pred_boxes.extend(detections_to_eval_boxes(f.sample_token, det))
        run.gt_boxes.extend(gt_to_eval_boxes(f.sample_token, f.gt_boxes, f.gt_labels))

    run.latencies = pipelined_loop(frames.frame, indices, dispatch, finish, pipelined)
    return run


def main(argv=None) -> EvalResult:
    """Parse `argv`, evaluate, print the metrics line; the result is
    returned for callers that drive the tool from Python."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r50", choices=MODELS)
    ap.add_argument("--infos", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--ranks-pad", type=int, default=400000,
                    help="pooling ranks padded to this many points (a static size)")
    ap.add_argument("--pool-impl", default="interval", choices=POOL_IMPLS,
                    help="the BEV splat's formulation (ops/bev_pool.py)")
    ap.add_argument("--quant-scales", default=None,
                    help=".npz of tools/bevdet/calibrate.py, with its policy")
    ap.add_argument("--quant", default="qdq", choices=("qdq", "int8"),
                    help="with --quant-scales: 'qdq' simulates quantization at the QDQ "
                         "sites, 'int8' runs the int8 product")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant, exclude = False, ()
    if args.quant_scales:
        quant = "int8" if args.quant == "int8" else True
        exclude = load_policy(args.quant_scales)
        if exclude:
            print(f"mixed precision: excluding {exclude}", file=sys.stderr)
    cfg = make_config(args.model, dtype=args.dtype, quant=quant, quant_exclude=exclude)
    frames = frames_of(cfg, args.infos, args.data_root)
    ranks = rig_ranks(cfg, frames.infos[0], args.ranks_pad,
                      intervals=args.pool_impl == "interval")
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVDetEngine(cfg, ranks, state_dict=state_dict, device=device,
                          pool_impl=args.pool_impl)
    if args.quant_scales:  # folds the int8 weights from this checkpoint's weights
        attach_quant_scales(engine.model, CalibrationResult.load(args.quant_scales).scales)
    indices = list(range(len(frames)))[:args.limit]

    run = eval_loop(engine, frames, indices)
    metrics = run.metrics()
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return EvalResult(metrics, run, engine, frames, indices)


if __name__ == "__main__":
    main()
