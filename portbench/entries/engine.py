"""Entry `engine`: one car's perception loop on `runtime/engine.py`.

The car hands a frame to `BEVFormerEngine.infer_frame` and waits for its
detections on the host (`readback(...).result()`) before it hands the next:
one frame in flight, batch 1.  A frame's latency runs from the hand-over to
the detections on the host.  A second `run` goes on where the first
stopped.
"""
from __future__ import annotations

import contextlib
import time

from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine

from ..record import Capture, Frame, Run, detections


class Entry:
    def __init__(self, cfg, state_dict, traffic, params, device):
        if int(params["vehicles"]) != 1 or int(params["batch"]) != 1:
            raise ValueError("entry 'engine' serves one vehicle at batch 1")
        self.engine = BEVFormerEngine(cfg, state_dict=state_dict, device=device)
        self.model = self.engine.model
        self.traffic = traffic
        self.capture = Capture(self.model)
        self.k = self.f = 0  # the next frame: scene k, frame f

    def calibrate(self, frames, method: str) -> None:
        self.engine.calibrate(
            [{k: f[k] for k in ("image", "can_bus", "lidar2img", "scene_token")} for f in frames],
            method=method)

    def warm_up(self, frames) -> None:
        """The window's calls on `frames`, then a fresh temporal state."""
        for f in frames:
            out = self.engine.infer_frame(f["image"], f["can_bus"], f["lidar2img"],
                                          f["scene_token"])
            self.engine.readback(*out).result()
        self.engine.reset()

    def run(self, t_end: float, keep: set, span) -> Run:
        run = Run()
        while time.perf_counter() < t_end:
            key = (0, self.k, self.f)
            frame = self.traffic.frame(*key)
            run.attempted += 1
            # the decoder's states are taken only of the checked frames
            capture = self.capture if key in keep else contextlib.nullcontext()
            with span("infer_frame"), capture:
                t0 = time.perf_counter()
                classes, coords = self.engine.infer_frame(
                    frame["image"], frame["can_bus"], frame["lidar2img"], frame["scene_token"])
                t1 = time.perf_counter()
            with span("readback"):
                host = self.engine.readback(classes, coords).result()
            t2 = time.perf_counter()
            run.frames.append(Frame(key, t0, t2, enqueue_s=t1 - t0))
            if key in keep:
                bev = self.engine.state.prev_bev
                run.kept[key] = (bev.reshape(bev.shape[0], -1).clone(), *detections(host),
                                 self.capture.outputs[0])
            if self.f + 1 == self.traffic.frames_per_scene:
                self.k, self.f = self.k + 1, 0
            else:
                self.f += 1
        return run
