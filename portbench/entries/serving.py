"""Entry `serving`: a card serving a fleet's camera streams on
`runtime/serving.py::ContinuousBatchingEngine`, at saturation.

A closed loop with no think time: each of `vehicles` vehicles has one frame
outstanding and submits its next frame as soon as the previous frame's
detections return from `step()`, so with as many vehicles as lanes every
step is full and the window measures the most frames a second the engine
turns out.  When a vehicle's scene ends, its scene is finished
(`finish_scene`, which frees the scene's slot) and its next scene, a new
scene id, claims a slot when it is first scheduled.  A frame's latency runs
from when it became ready (submitted) until the step that took it returned
its detections on the host.  A second `run` goes on where the first
stopped.
"""
from __future__ import annotations

import contextlib
import time

from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.serving import ContinuousBatchingEngine, FrameRequest

from ..record import Capture, Frame, Run, detections

SCENE_IDS = 1_000_000  # scene id = vehicle * SCENE_IDS + scene


class Entry:
    def __init__(self, cfg, state_dict, traffic, params, device):
        self.engine = ContinuousBatchingEngine(cfg, state_dict=state_dict, device=device,
                                               max_scenes=int(params["max_scenes"]),
                                               batch=int(params["batch"]))
        self.model = self.engine.model
        self.traffic = traffic
        self.vehicles = int(params["vehicles"])
        self.C = cfg.embed_dims
        self.capture = Capture(self.model)
        self.started = False

    def calibrate(self, frames, method: str) -> None:
        BEVFormerEngine(self.engine.cfg, model=self.model,
                        device=self.engine.device).calibrate(
            [{k: f[k] for k in ("image", "can_bus", "lidar2img", "scene_token")} for f in frames],
            method=method)

    def _submit(self, v: int, k: int, f: int, ready: float) -> None:
        fr = self.traffic.frame(v, k, f)
        self.engine.submit(FrameRequest(
            scene_id=v * SCENE_IDS + k, image=fr["image"], can_bus=fr["can_bus"],
            lidar2img=fr["lidar2img"], scene_token=fr["scene_token"], tag=(v, k, f, ready)))

    def warm_up(self, frames) -> None:
        """Full steps of the window's shape on `frames` (every lane a scene
        of its own), once as scenes' first frames and once carrying their
        BEV, then the scenes are finished."""
        for rnd in range(2):
            for i in range(self.engine.batch):
                f = frames[(rnd * self.engine.batch + i) % len(frames)]
                self.engine.submit(FrameRequest(scene_id=-1 - i, image=f["image"],
                                                can_bus=f["can_bus"], lidar2img=f["lidar2img"],
                                                scene_token=f"warm-{i}"))
            self.engine.step()
        for i in range(self.engine.batch):
            self.engine.finish_scene(-1 - i)

    def run(self, t_end: float, keep: set, span) -> Run:
        run = Run()
        F = self.traffic.frames_per_scene
        if not self.started:
            self.started = True
            t = time.perf_counter()
            for v in range(self.vehicles):
                self._submit(v, 0, 0, t)
                run.attempted += 1
        while time.perf_counter() < t_end:
            # the decoder's states are taken only in steps that may hold a
            # checked frame; the lanes' calls come in the order of `got`
            checked = any(q[0].tag[:3] in keep for q in self.engine.queues.values() if q)
            capture = self.capture if checked else contextlib.nullcontext()
            with span("step"), capture:
                ts = time.perf_counter()
                got = self.engine.step()
                te = time.perf_counter()
            run.steps.append((ts, te, len(got)))
            with span("bookkeeping"):
                for lane, ((v, k, f, ready), classes, coords) in enumerate(got):
                    run.frames.append(Frame((v, k, f), ready, te, queue_s=ts - ready))
                    if (v, k, f) in keep:
                        slot = self.engine.scenes[v * SCENE_IDS + k].slot
                        bev = self.engine.pool[slot].reshape(-1, self.C).clone()
                        run.kept[(v, k, f)] = (bev, *detections((classes, coords)),
                                               self.capture.outputs[lane])
                    if f + 1 == F:
                        self.engine.finish_scene(v * SCENE_IDS + k)
                        k, f = k + 1, 0
                    else:
                        f += 1
                    self._submit(v, k, f, time.perf_counter())
                    run.attempted += 1
        return run
