"""Continuous-batching serving throughput (port of `tools/serving_bench.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.serving_bench --model tiny
        [--scenes 4] [--frames 8] [--batch 4] [--dtype bfloat16]
        [--skip-sequential] [--repeats 1] [--device cuda]

Serves a synthetic stream of `--scenes` scenes x `--frames` frames through
`runtime/serving.py::ContinuousBatchingEngine` (seeded weights, one seeded
image for every frame, a seeded can_bus per frame, the nuScenes-like rig of
`runtime/synthetic.py`) and compares it with the sequential batch-1 loop,
the reference's only deployment (one frame at a time, prev_bev kept on the
device, each frame's coords read back).  Throughput is frames/s over all
scenes; each scene's frames run in order.

The last line of stdout is one JSON object: `metric`
(`serving_{model}_batch{B}_fps`), `value`, `unit`, `scenes`,
`frames_per_scene`, `compile_s` (the first drain's extra seconds over the
first timed drain: the kernels' load and cuDNN's first calls; the port
compiles nothing at run time), `sequential_fps` and `speedup_vs_sequential`.
With `--repeats N` the timed drain and the sequential loop alternate N
times after the warm-up: `value`, `sequential_fps` and
`speedup_vs_sequential` are the medians, and `repeats`, `serving_fps_runs`,
`sequential_fps_runs` and `speedup_runs` give every run.  Every clock read
follows a device synchronise.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import bevformer as configs
from ..runtime.engine import BEVFormerEngine, resolve_device
from ..runtime.serving import ContinuousBatchingEngine, FrameRequest
from ..runtime.synthetic import nuscenes_like_rig

MODELS = ("micro", "tiny", "small", "base")


def stream(cfg, scenes: int, frames: int) -> List[FrameRequest]:
    """The bench's requests, scene by scene: one seeded image, the rig, a
    seeded can_bus per frame; tags (scene, frame)."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32)
    l2i = (nuscenes_like_rig(cfg.img_w, cfg.img_h)[:cfg.num_cams]
           .reshape(1, cfg.num_cams, 4, 4).astype(np.float32))
    return [FrameRequest(scene_id=s, image=image,
                         can_bus=rng.standard_normal(cfg.can_bus_dims).astype(np.float32),
                         lidar2img=l2i, tag=(s, f))
            for s in range(scenes) for f in range(frames)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_drain(engine: ContinuousBatchingEngine, reqs: List[FrameRequest]):
    """(results, seconds) of submitting `reqs` and draining them, then
    releasing their scenes."""
    for r in reqs:
        engine.submit(r)
    _sync(engine.device)
    t0 = time.perf_counter()
    got = engine.drain()
    _sync(engine.device)
    dt = time.perf_counter() - t0
    for s in sorted({r.scene_id for r in reqs}):
        engine.finish_scene(s)
    if len(got) != len(reqs):
        raise RuntimeError(f"served {len(got)} of {len(reqs)} frames")
    return got, dt


def sequential_fps(engine: BEVFormerEngine, reqs: List[FrameRequest]) -> float:
    """Frames/s of the batch-1 loop over `reqs` (after one warm-up frame):
    prev_bev on the device, each frame's coords read back."""
    engine.reset()
    engine.infer_frame(reqs[0].image, reqs[0].can_bus, reqs[0].lidar2img, "warm-up")
    _sync(engine.device)
    engine.reset()
    t0 = time.perf_counter()
    for r in reqs:
        _, coords = engine.infer_frame(r.image, r.can_bus, r.lidar2img, r.scene_id)
        coords.cpu()
    _sync(engine.device)
    return len(reqs) / (time.perf_counter() - t0)


def bench(cfg, scenes: int, frames: int, batch: int, device=None, skip_sequential=False,
          engine: Optional[ContinuousBatchingEngine] = None, repeats: int = 1) -> Dict:
    """The bench's record for `cfg` with seeded weights (an `engine` may be
    given instead: its model and pool are used, its scenes must be
    finished); `repeats` alternations of the timed drain and the
    sequential loop."""
    device = resolve_device(device)
    if engine is None:
        engine = ContinuousBatchingEngine(cfg, device=device, max_scenes=max(scenes, batch),
                                          batch=batch)
    reqs = stream(cfg, scenes, frames)
    _, dt_warm = timed_drain(engine, reqs)
    sequential = None if skip_sequential else BEVFormerEngine(cfg, model=engine.model,
                                                              device=device)
    fps, seq = [], []
    for _ in range(repeats):
        fps.append(len(reqs) / timed_drain(engine, reqs)[1])
        if sequential is not None:
            seq.append(sequential_fps(sequential, reqs))
    rec = {"metric": f"serving_{cfg.name}_batch{engine.batch}_fps",
           "value": float(np.median(fps)), "unit": "frames/s", "scenes": scenes,
           "frames_per_scene": frames, "compile_s": dt_warm - len(reqs) / fps[0]}
    if seq:
        ratios = [a / b for a, b in zip(fps, seq)]
        rec.update(sequential_fps=float(np.median(seq)),
                   speedup_vs_sequential=float(np.median(ratios)))
    if repeats > 1:
        rec.update(repeats=repeats, serving_fps_runs=fps, sequential_fps_runs=seq,
                   speedup_runs=ratios if seq else [])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=MODELS)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8, help="frames per scene")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--skip-sequential", action="store_true")
    ap.add_argument("--repeats", type=int, default=1,
                    help="alternations of the timed drain and the sequential loop")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = getattr(configs, f"bevformer_{args.model}")(dtype=args.dtype)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    rec = bench(cfg, args.scenes, args.frames, args.batch, device, args.skip_sequential,
                repeats=args.repeats)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
