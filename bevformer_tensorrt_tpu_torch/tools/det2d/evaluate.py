"""Evaluate the 2D family (YOLOX / CenterNet) on a COCO-format set: mAP and
FPS (port of `tools/2d/evaluate.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.det2d.evaluate <model> --ann <instances.json>
        --img-root DIR [--checkpoint upstream.pth] [--batch 8] [--dtype bfloat16]
        [--limit N] [--quant-scales scales.npz [--quant int8|qdq]
        [--quant-exclude PATTERN ...]] [--device cuda]

`model` is one of yolox_x, yolox_s, yolox_micro, centernet_r18 (DCNv2 neck)
and centernet_micro.  The loader (`data/coco.py`: letterboxed to the
config's square, CenterNet with its RGB mean / std) feeds
`Det2DEngine` in batches of `--batch` (a short last batch is padded with
zero images); the decode runs on the card, the post-processing (YOLOX's
class-aware NMS, CenterNet's score threshold) on the host.  The loop is the
JAX tool's pipelined one: batch b+1 is dispatched before batch b is read
back into pinned memory and post-processed.  It runs on the nuScenes
evaluators' `tools/evaluate.py::pipelined_loop`, whose one-thread
prefetcher loads the next batch's images meanwhile; the JAX tool loads each
batch in the loop.  The last line of stdout is one JSON object of the
rounded mAP, mAP_50, mAP_75 and fps.

`fps` keeps the JAX tool's division (`tools/2d/evaluate.py:164-172`): each
interval between two finished batches, which also holds the next batch's
dispatch, is divided by the size of the batch just finished, and the first
interval is dropped.  Near a short last batch the figure is skewed.  The
interval is not the JAX tool's: there it also holds the next batch's
loading, here the loading overlaps it, so for a loader-bound model the two
tools' fps differ.

`--checkpoint` is an upstream-layout state_dict (`.pth`); without it the
weights are seeded.  `--quant-scales` is a `.npz` of
`tools/det2d/calibrate.py`; its policy (the `.policy.json` beside it) is the
default of `--quant-exclude`.  'int8' (the default, as the JAX tool's) runs
every convolution on the int8 product with its weights folded from this
checkpoint's, and CenterNet-R18's DCN blocks sample the int8 table; 'qdq'
simulates the quantization.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np

from ...data.coco import CocoDataset, CocoSample
from ...evalsuite import evaluate_coco_map
from ...quant.fold import attach_quant_scales
from ...quant.observers import CalibrationResult
from ...quant.policy import load_policy
from ...runtime.det2d_engine import (
    MODELS,
    Det2DEngine,
    image_norm,
    load_checkpoint_state_dict,
    make_config,
)
from ...runtime.engine import resolve_device
from ...runtime.torch_import import load_torch_checkpoint
from ..evaluate import pipelined_loop


def dataset_of(model: str, cfg, ann: str, img_root: str) -> CocoDataset:
    return CocoDataset(ann, img_root, img_size=cfg.img_size, **image_norm(model))


def batch_images(samples: Sequence[CocoSample], batch: int, size: int) -> np.ndarray:
    """[batch, 3, size, size] float32: the samples' images, then zeros."""
    out = np.zeros((batch, 3, size, size), np.float32)
    for i, s in enumerate(samples):
        out[i] = s.image
    return out


@dataclasses.dataclass
class Det2DRun:
    """What one pass of `eval_loop` produced, in image order: each image's
    (boxes, scores, labels), the GT and prediction dicts of the mAP, and the
    per-image latencies (seconds, the JAX tool's measure) and each image's
    host post-processing ms (YOLOX's NMS, CenterNet's threshold)."""

    detections: List[tuple] = dataclasses.field(default_factory=list)
    gt: list = dataclasses.field(default_factory=list)
    pred: list = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)
    post_ms: List[float] = dataclasses.field(default_factory=list)

    def metrics(self, num_classes: int) -> Dict[str, float]:
        metrics = evaluate_coco_map(self.gt, self.pred, num_classes)
        lat = self.latencies[1:] if len(self.latencies) > 1 else self.latencies
        metrics["fps"] = 1.0 / float(np.mean(lat))
        return metrics


def eval_loop(engine: Det2DEngine, ds: CocoDataset, indices: Sequence[int], batch: int,
              pipelined: bool = True) -> Det2DRun:
    """The images of `indices` in batches through the engine
    (`tools.evaluate.pipelined_loop`).  Pipelined, batch b is read back and
    post-processed after batch b+1 is dispatched; serial, before.  Both give
    the same detections."""
    run = Det2DRun()
    chunks = [list(indices[s:s + batch]) for s in range(0, len(indices), batch)]
    size = engine.cfg.img_size

    def load(c):
        return [ds.sample(i) for i in chunks[c]]

    def dispatch(samples):
        return engine.readback(*engine.infer(batch_images(samples, batch, size)))

    def finish(samples, pending):
        decoded = [t.numpy() for t in pending.result()]
        for i, sm in enumerate(samples):
            t0 = time.perf_counter()
            b, s, lab = engine.post(decoded, i, sm.scale)
            run.post_ms.append((time.perf_counter() - t0) * 1e3)
            run.detections.append((b, s, lab))
            run.gt.extend(sm.gt)
            run.pred.extend({"image_id": sm.image_id, "category_id": int(li),
                             "bbox": bi.tolist(), "score": float(si)}
                            for bi, si, li in zip(b, s, lab))

    latencies = pipelined_loop(load, range(len(chunks)), dispatch, finish, pipelined)
    run.latencies = [t / len(c) for t, c in zip(latencies, chunks)]
    return run


@dataclasses.dataclass
class Det2DResult:
    """What `main` ran, for callers that drive the tool from Python."""

    metrics: Dict[str, float]
    run: Det2DRun
    engine: Det2DEngine
    dataset: CocoDataset
    indices: List[int]
    batch: int


def main(argv=None) -> Det2DResult:
    """Parse `argv`, evaluate, print the metrics line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--quant-scales", default=None,
                    help=".npz of tools/det2d/calibrate.py, with its policy")
    ap.add_argument("--quant", default="int8", choices=("qdq", "int8"),
                    help="with --quant-scales: 'qdq' fake-quant simulation, 'int8' real int8 "
                         "convolutions (the deploy path)")
    ap.add_argument("--quant-exclude", action="append", default=None,
                    help="mixed precision: site patterns kept in floating point; defaults to "
                         "the policy saved beside --quant-scales")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant, exclude = False, ()
    if args.quant_scales:
        quant = "int8" if args.quant == "int8" else True
        exclude = (tuple(p for p in args.quant_exclude if p) if args.quant_exclude is not None
                   else load_policy(args.quant_scales))
        if exclude:
            print(f"mixed precision: excluding {exclude}", file=sys.stderr)
    cfg = make_config(args.model, dtype=args.dtype, quant=quant, quant_exclude=exclude)
    ds = dataset_of(args.model, cfg, args.ann, args.img_root)
    state_dict = (load_checkpoint_state_dict(cfg, load_torch_checkpoint(args.checkpoint))
                  if args.checkpoint else None)
    engine = Det2DEngine(cfg, state_dict=state_dict, device=device)
    if args.quant_scales:  # folds the int8 weights from this checkpoint's weights
        attach_quant_scales(engine.model, CalibrationResult.load(args.quant_scales).scales)
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    indices = list(range(n))
    run = eval_loop(engine, ds, indices, args.batch)
    metrics = run.metrics(cfg.num_classes)
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return Det2DResult(metrics, run, engine, ds, indices, args.batch)


if __name__ == "__main__":
    main()
