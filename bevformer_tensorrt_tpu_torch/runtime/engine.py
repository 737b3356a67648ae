"""Inference engine: the model on its device plus the host-side temporal
state machine (port of `bevformer_tensorrt_tpu/runtime/engine.py`).

  * scene change -> use_prev_bev = 0
  * can_bus[:3] / can_bus[-1] become deltas vs the previous frame
  * prev_bev <- bev_embed, kept on the device; only the detections are
    read back by the caller.

A quantized model (`cfg.quant`) is served like any other once its scales
are in place: from the state_dict, from
`quant.fold.attach_quant_scales(engine.model, scales)`, or from `calibrate`
over a few frames.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.bevformer import BEVFormerConfig
from ..models.detectors.bevformer import BEVFormer
from ..models.modules.encoder import cam_budget_overflow
from ..quant.calibrate import calibrate as calibrate_sites
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..weights import init_weights


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another.
    Raises when CUDA is wanted and absent, rather than running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class TemporalState:
    """prev_bev / prev_pos / prev_angle / scene_token carrier."""

    def __init__(self):
        self.prev_bev = None
        self.prev_pos = np.zeros(3, np.float32)
        self.prev_angle = np.float32(0.0)
        self.scene_token = None

    def step_can_bus(
        self, can_bus: np.ndarray, scene_token, has_prev: bool | None = None
    ) -> tuple[np.ndarray, float]:
        """Returns (delta_can_bus, use_prev_bev).

        `has_prev` overrides the `self.prev_bev is not None` check for callers
        that keep the recurrent BEV outside this object."""
        can_bus = np.array(can_bus, np.float32, copy=True)
        tmp_pos = can_bus[:3].copy()
        tmp_angle = np.float32(can_bus[-1])
        if has_prev is None:
            has_prev = self.prev_bev is not None
        use_prev = 1.0 if (scene_token == self.scene_token and has_prev) else 0.0
        if use_prev:
            can_bus[:3] -= self.prev_pos
            can_bus[-1] -= self.prev_angle
        else:
            can_bus[:3] = 0.0
            can_bus[-1] = 0.0
        self.prev_pos = tmp_pos
        self.prev_angle = tmp_angle
        self.scene_token = scene_token
        return can_bus, use_prev


class BEVFormerEngine:
    """Per-frame BEVFormer inference with the recurrent BEV kept on the device.

    `model` defaults to a `BEVFormer(cfg)` with seeded weights
    (`init_weights` from `seed`); `state_dict` (e.g. from
    `weights.params_from_jax`) is loaded strictly when given."""

    def __init__(self, cfg: BEVFormerConfig, model: Optional[BEVFormer] = None,
                 state_dict=None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        if model is None:
            model = BEVFormer(cfg)
            if state_dict is None:
                init_weights(model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self._cam_budget_warned = False
        self.state = TemporalState()

    def reset(self):
        self.state = TemporalState()

    def _check_cam_budget(self, lidar2img) -> None:
        """Warn once if this rig makes a camera see more visible BEV queries
        than the static compaction budget K (those would be dropped)."""
        if self.cfg.cam_budget >= 1.0 or self._cam_budget_warned:
            return
        visible, overflow = cam_budget_overflow(self.cfg, np.asarray(lidar2img))
        if overflow > 0:
            self._cam_budget_warned = True
            warnings.warn(
                f"cam_budget={self.cfg.cam_budget} drops up to {overflow} visible BEV "
                f"queries/camera on this rig (per-camera visible counts "
                f"{visible.tolist()}); raise the budget for exact parity",
                RuntimeWarning, stacklevel=3)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def infer_frame(self, image, can_bus, lidar2img, scene_token: Any):
        """One frame.  Returns (outputs_classes, outputs_coords) on the device."""
        if scene_token != self.state.scene_token:
            l2i = lidar2img.cpu().numpy() if torch.is_tensor(lidar2img) else lidar2img
            self._check_cam_budget(l2i)
        delta_can_bus, use_prev = self.state.step_can_bus(
            can_bus.cpu().numpy() if torch.is_tensor(can_bus) else can_bus, scene_token)
        prev_bev = self.state.prev_bev
        if prev_bev is None:
            nq = self.cfg.bev_h * self.cfg.bev_w
            prev_bev = torch.zeros((nq, 1, self.cfg.embed_dims), device=self.device)
        bev_embed, classes, coords = self.model(
            self._tensor(image), prev_bev,
            torch.tensor(use_prev, dtype=torch.float32, device=self.device),
            self._tensor(delta_can_bus), self._tensor(lidar2img))
        self.state.prev_bev = bev_embed
        return classes, coords

    def calibrate(self, frames, method: str = "entropy",
                  percentile: float = 99.99) -> CalibrationResult:
        """Two-pass calibration of the model's QDQ sites over `frames`
        (keyword sets of `infer_frame`), each pass from a fresh temporal
        state; the chosen scales are attached (and, for int8 layers, the
        weights folded) and returned.  Leaves the temporal state reset."""
        result = calibrate_sites(
            lambda f: self.infer_frame(**f), self.model, frames, method=method,
            percentile=percentile, before_pass=self.reset)
        attach_quant_scales(self.model, result.scales)
        self.reset()
        return result

    def benchmark(self, frames, warmup: int = 1) -> Dict[str, float]:
        """Mean latency and FPS over the frames after `warmup`; each frame
        ends in a device synchronise."""
        lat = []
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            self.infer_frame(**f)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if i >= warmup:
                lat.append(dt)
        mean_ms = float(np.mean(lat) * 1000.0)
        return {"latency_ms": mean_ms, "fps": 1000.0 / mean_ms}
