"""BEVDet inference engine: the model on its device with one camera rig's
pooling ranks baked in, the decode on the device, and calibration (the
engine part of `tools/bevdet/evaluate.py` and `tools/bevdet/calibrate.py`
of the JAX package).

The ranks are made once on the host from the rig (`rig_ranks`), as the
reference bakes one sample's ranks into its TensorRT engine
(tools/bevdet/pth2onnx.py:60-97), and stay on the device as int64 tensors.
BEVDet carries no state from frame to frame.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs.bevdet import BEVDetConfig
from ..models.detectors.bevdet import BEVDet
from ..models.heads.centerpoint_head import centerpoint_decode
from ..models.necks.view_transformer import PoolingRanks, get_lidar_coor, voxel_pooling_prepare
from ..quant.calibrate import calibrate as calibrate_sites
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..weights import init_weights
from .engine import Readback, readback, resolve_device

POOL_IMPLS = ("interval", "scatter")


def rig_ranks(cfg: BEVDetConfig, info: dict, ranks_pad: Optional[int] = 400000,
              intervals: bool = True) -> PoolingRanks:
    """The pooling ranks of one infos entry's camera rig (its cams'
    sensor2lidar rotation and translation and intrinsics), padded to
    `ranks_pad` points; with `intervals`, the interval arrays padded to
    every cell of the grid."""
    cams = list(info["cams"].values())
    s2e = np.stack([
        np.block([
            [np.asarray(c["sensor2lidar_rotation"], np.float64),
             np.asarray(c["sensor2lidar_translation"], np.float64)[:, None]],
            [np.zeros((1, 3)), np.ones((1, 1))],
        ]) for c in cams]).astype(np.float32)
    intr = np.stack([np.asarray(c["cam_intrinsic"], np.float32) for c in cams])
    gz = int(round((cfg.grid_zbound[1] - cfg.grid_zbound[0]) / cfg.grid_zbound[2]))
    return voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=ranks_pad,
                                 pad_intervals_to=cfg.bev_h * cfg.bev_w * gz if intervals
                                 else None)


class RigModel(torch.nn.Module):
    """BEVDet with one rig's pooling ranks held as buffers: `forward(image)`
    is the detector on them.  The exported program's only input is then the
    image, as the reference bakes the ranks into its engine."""

    def __init__(self, model: BEVDet, rank_args: Sequence[torch.Tensor]):
        super().__init__()
        self.model = model
        self.names = tuple(f"rank{i}" for i in range(len(rank_args)))
        for name, t in zip(self.names, rank_args):
            self.register_buffer(name, t)

    def forward(self, image) -> Dict[str, torch.Tensor]:
        return self.model(image, *(getattr(self, n) for n in self.names))


class BEVDetEngine:
    """Per-frame BEVDet inference on one rig.  `model` defaults to a
    `BEVDet(cfg)` with seeded weights; `state_dict` (from
    `runtime.torch_import.load_bevdet_checkpoint`, or
    `weights.params_from_jax`) is loaded strictly when given.  `pool_impl`
    is the splat's formulation (`ops.bev_pool`)."""

    def __init__(self, cfg: BEVDetConfig, ranks: PoolingRanks, model: Optional[BEVDet] = None,
                 state_dict=None, device=None, seed: int = 0, pool_impl: str = "interval"):
        if pool_impl not in POOL_IMPLS:
            raise ValueError(f"pool_impl {pool_impl!r}: expected one of {POOL_IMPLS}")
        self.device = resolve_device(device)
        self.cfg = cfg
        if model is None:
            model = BEVDet(cfg)
            if state_dict is None:
                init_weights(model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.ranks = ranks
        arrays = (ranks.ranks_depth, ranks.ranks_feat, ranks.ranks_bev) + (
            (ranks.interval_starts, ranks.interval_lengths) if pool_impl == "interval" else ())
        self.rank_args = tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                               device=self.device) for a in arrays)

    @property
    def valid_points(self) -> int:
        return int((np.asarray(self.ranks.ranks_bev) >= 0).sum())

    @property
    def intervals(self) -> int:
        return int((np.asarray(self.ranks.interval_lengths) > 0).sum())

    @torch.inference_mode()
    def heads(self, image) -> Dict[str, torch.Tensor]:
        """The head maps of one frame (`image` [1, cams, 3, H, W])."""
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        return self.model(image, *self.rank_args)

    @torch.inference_mode()
    def infer_frame(self, image):
        """One frame: (boxes, scores, labels, valid) of the decode, on the
        device (`centerpoint_decode`)."""
        return centerpoint_decode(self.cfg, self.heads(image))

    def readback(self, *tensors: torch.Tensor) -> Readback:
        return readback(self.device, *tensors)

    def calibrate(self, images: Sequence, method: str = "entropy",
                  percentile: float = 99.99) -> CalibrationResult:
        """Two-pass calibration of the model's QDQ sites over `images`; the
        chosen scales are attached (and, for int8 layers, the weights
        folded) and returned."""
        result = calibrate_sites(self.heads, self.model, images, method=method,
                                 percentile=percentile)
        attach_quant_scales(self.model, result.scales)
        return result
