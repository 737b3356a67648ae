"""Evaluate BEVFormer on a nuScenes-layout set: NDS / mAP and FPS
(port of `tools/bevformer/evaluate.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.evaluate tiny --infos <infos.pkl>
        [--data-root DIR] [--checkpoint upstream.pth] [--dtype bfloat16]
        [--quant-scales scales.npz [--quant int8] [--quant-exclude PATTERN ...]]
        [--limit N] [--cam-budget 1.0] [--device cuda] [--distributed [--partial-dir DIR]]

The loader (`data/nuscenes.py`) feeds `BEVFormerEngine`, the NMS-free
decode follows, then `evaluate_nuscenes`.  The last line of stdout is one
JSON object of the rounded metrics with `fps` and `latency_ms` (the first
and last frames' latencies dropped, the reference's convention).

`--checkpoint` is an upstream-layout state_dict (`.pth`); without it the
weights are seeded.  `--quant-scales` is a `CalibrationResult` `.npz` from
`tools/calibrate.py`, with its `.policy.json` beside it.  Left out (the JAX
CLI has it): `--knobs` (autotuned Mosaic knobs; the port's kernels pick
their geometry by rule).  Runs on CUDA unless `--device cpu` is given.

`--distributed` (or torchrun's variables in the environment) evaluates over
the job torchrun describes: whole scenes a rank (`scene_group_shards`; the
recurrent prev_bev never crosses ranks), each rank on `cuda:LOCAL_RANK`.
Each rank writes `eval_partial_<rank>.pkl` under
`<--partial-dir, default beside --infos>/partials_<MASTER_ADDR>_<MASTER_PORT>`
and waits at a barrier of a gloo group (host coordination: no NCCL
communicator is made, so ranks may share a card); rank 0 merges the
partials and prints the metrics (fps and latency from its own frames).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..configs import bevformer as configs
from ..core.nms_free_coder import NMSFreeCoder
from ..data.nuscenes import IMG_NORM_CAFFE, IMG_NORM_PYTORCH, NuScenesFrames
from ..data.sampler import scene_group_shards
from ..evalsuite import detections_to_eval_boxes, evaluate_nuscenes, gt_to_eval_boxes
from ..parallel import init_distributed
from ..parallel.mesh import in_torchrun
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..quant.policy import load_policy
from ..runtime.engine import BEVFormerEngine
from ..runtime.torch_import import load_bevformer_checkpoint, load_torch_checkpoint

MODELS = ("micro", "tiny", "small", "base")


def image_norm(model: str):
    """tiny is the pytorch-style R50; the R101 configs (and micro) are caffe-style."""
    return IMG_NORM_PYTORCH if model == "tiny" else IMG_NORM_CAFFE


def checkpoint_state_dict(cfg, path: str):
    """The port's state_dict from an upstream-layout checkpoint file."""
    return load_bevformer_checkpoint(cfg, load_torch_checkpoint(path))


@dataclasses.dataclass
class EvalRun:
    """What one pass of `eval_loop` produced, in frame order."""

    detections: List[Dict[str, np.ndarray]] = dataclasses.field(default_factory=list)
    gt_boxes: list = dataclasses.field(default_factory=list)
    pred_boxes: list = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)  # seconds

    def metrics(self) -> Dict[str, float]:
        metrics = evaluate_nuscenes(self.gt_boxes, self.pred_boxes, verbose=True)
        lat = self.latencies[1:-1] if len(self.latencies) > 2 else self.latencies
        metrics["fps"] = 1.0 / float(np.mean(lat))
        metrics["latency_ms"] = float(np.mean(lat) * 1e3)
        return metrics


def pipelined_loop(load: Callable, indices: Sequence, dispatch: Callable, finish: Callable,
                   pipelined: bool = True) -> List[float]:
    """Drive the items `load(index)` of `indices` through
    `dispatch(item) -> pending` and `finish(item, pending)`, in order;
    returns the latencies (seconds, the time between two finished items).
    A one-thread prefetcher loads item t+1 while item t runs.  Pipelined,
    item t is finished after item t+1 is dispatched, so the host's work on
    item t (its readback and decode) overlaps the card's work on item t+1;
    serial, each item is finished before the next is dispatched."""
    n = len(indices)
    latencies: List[float] = []
    pending = None
    with ThreadPoolExecutor(max_workers=1) as prefetch:
        t_last = time.perf_counter()
        fut = prefetch.submit(load, indices[0]) if n else None
        for step in range(n):
            item = fut.result()
            if step + 1 < n:
                fut = prefetch.submit(load, indices[step + 1])
            current = (item, dispatch(item))
            if not pipelined:
                pending, current = current, None
            if pending is not None:
                finish(*pending)
                now = time.perf_counter()
                latencies.append(now - t_last)
                t_last = now
            pending = current
            if step % 100 == 0:
                print(f"[{step}/{n}]", file=sys.stderr)
        if pending is not None:
            finish(*pending)
            latencies.append(time.perf_counter() - t_last)
    return latencies


def eval_loop(engine: BEVFormerEngine, frames: NuScenesFrames, indices: Sequence[int],
              pipelined: bool = True) -> EvalRun:
    """Run the frames through the engine from a fresh temporal state, decode
    and convert them (`pipelined_loop`: frame t's readback is started right
    after its dispatch and it is decoded after frame t+1 is dispatched, or,
    serial, before).  Both give the same detections."""
    coder = NMSFreeCoder(num_classes=engine.cfg.num_classes)
    run = EvalRun()

    def dispatch(f):
        classes, coords = engine.infer_frame(f.image, f.can_bus, f.lidar2img, f.scene_token)
        return engine.readback(classes, coords)

    def finish(f, readback):
        classes, coords = readback.result()
        det = coder.decode(classes, coords)[0]
        run.detections.append(det)
        run.pred_boxes.extend(detections_to_eval_boxes(f.sample_token, det))
        run.gt_boxes.extend(gt_to_eval_boxes(f.sample_token, f.gt_boxes, f.gt_labels))

    engine.reset()
    run.latencies = pipelined_loop(frames.frame, indices, dispatch, finish, pipelined)
    return run


def merge_partials(run: EvalRun, partial_dir: str, infos: str) -> Optional[EvalRun]:
    """Write this rank's boxes under the run's partials directory, wait at
    a gloo barrier, and on rank 0 return the run with every rank's boxes
    (rank order; the latencies rank 0's); None on the other ranks."""
    rank, world = dist.get_rank(), dist.get_world_size()
    ns = f"{os.environ['MASTER_ADDR']}_{os.environ['MASTER_PORT']}".replace("/", "_")
    pdir = Path(partial_dir or Path(infos).parent) / f"partials_{ns}"
    pdir.mkdir(parents=True, exist_ok=True)
    with open(pdir / f"eval_partial_{rank}.pkl", "wb") as fh:
        pickle.dump({"gt": run.gt_boxes, "pred": run.pred_boxes}, fh)
    dist.barrier(group=dist.new_group(backend="gloo"))
    if rank != 0:
        return None
    merged = EvalRun(latencies=run.latencies)
    for r in range(world):
        with open(pdir / f"eval_partial_{r}.pkl", "rb") as fh:
            part = pickle.load(fh)
        merged.gt_boxes += part["gt"]
        merged.pred_boxes += part["pred"]
    return merged


@dataclasses.dataclass
class EvalResult:
    metrics: Dict[str, float]
    run: EvalRun
    engine: BEVFormerEngine
    frames: NuScenesFrames
    indices: List[int]


def main(argv=None) -> EvalResult:
    """Parse `argv`, evaluate, print the metrics line; the result is
    returned for callers that drive the tool from Python."""
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported from the JAX CLI: --knobs.")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--infos", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None, help="upstream-layout state_dict (.pth)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--quant-scales", default=None,
                    help="CalibrationResult .npz from tools/calibrate.py")
    ap.add_argument("--quant", default="qdq", choices=("qdq", "int8"),
                    help="with --quant-scales: 'qdq' simulates quantization at the QDQ "
                         "sites, 'int8' runs the int8 products and kernels")
    ap.add_argument("--quant-exclude", action="append", default=None,
                    help="site pattern kept in floating point (repeatable); default: the "
                         "policy saved beside --quant-scales; '' asks for none")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--cam-budget", type=float, default=1.0,
                    help="fraction of BEV queries kept per camera (1.0 = exact)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    ap.add_argument("--distributed", action="store_true",
                    help="scene-sharded evaluation over the job torchrun describes (also "
                         "implied by its variables); rank 0 merges the partial boxes")
    ap.add_argument("--partial-dir", default=None,
                    help="shared directory for the ranks' partial results (default: beside "
                         "--infos)")
    args = ap.parse_args(argv)
    distributed = args.distributed or in_torchrun()
    device = args.device
    if distributed:
        device, _, _ = init_distributed(args.device)

    quant, exclude = False, ()
    if args.quant_scales:
        quant = "int8" if args.quant == "int8" else True
        exclude = (tuple(p for p in args.quant_exclude if p) if args.quant_exclude is not None
                   else load_policy(args.quant_scales))
        if exclude:
            print(f"mixed precision: excluding {exclude}", file=sys.stderr)
    cfg = getattr(configs, f"bevformer_{args.model}")(
        dtype=args.dtype, quant=quant, cam_budget=args.cam_budget, quant_exclude=exclude)
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVFormerEngine(cfg, state_dict=state_dict, device=device)
    if args.quant_scales:
        attach_quant_scales(engine.model, CalibrationResult.load(args.quant_scales).scales)
    frames = NuScenesFrames(args.infos, args.data_root, img_norm=image_norm(args.model),
                            target_hw=(cfg.img_h, cfg.img_w))
    indices = list(range(len(frames)))
    if distributed:  # whole scenes a rank, timestamp order within each
        tokens = [e.get("scene_token", "") for e in frames.infos]
        indices = scene_group_shards(tokens, dist.get_world_size())[dist.get_rank()]
    indices = indices[:args.limit]

    run = eval_loop(engine, frames, indices)
    if distributed:
        merged = merge_partials(run, args.partial_dir, args.infos)
        dist.destroy_process_group()
        if merged is None:
            return EvalResult({}, run, engine, frames, indices)
        run = merged
    metrics = run.metrics()
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return EvalResult(metrics, run, engine, frames, indices)


if __name__ == "__main__":
    main()
