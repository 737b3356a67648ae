"""LSS view transformer: depth net, frustum geometry, BEV splat (port of
`bevformer_tensorrt_tpu/models/necks/view_transformer.py`).

The reference's LSSViewTransformer (third_party/bev_mmdet3d/models/necks/
view_transformer.py:36-330): a 1x1 conv predicts D depth logits and C
context channels per pixel, the depth takes a softmax, and the outer product
depth x context is splatted into the BEV grid by `ops.bev_pool.bev_pool_v2`
with rank tensors made once on the host from the camera rig (the reference
bakes one sample's ranks into its engine, tools/bevdet/pth2onnx.py:60-97).

The geometry (frustum -> lidar coordinates -> sorted ranks) is numpy that
depends on the calibration alone; it is copied from the JAX module, so its
ranks are the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...configs.bevdet import BEVDetConfig
from ...ops.bev_pool import bev_pool_v2
from ..layers import QConv


def make_frustum(cfg: BEVDetConfig) -> np.ndarray:
    """[D, Hf, Wf, 3] (pixel x, pixel y, depth) — view_transformer.py:88-124."""
    lo, hi, step = cfg.depth_bound
    D = cfg.depth_bins
    d = np.arange(lo, hi, step, dtype=np.float32).reshape(D, 1, 1)
    d = np.broadcast_to(d, (D, cfg.feat_h, cfg.feat_w))
    x = np.linspace(0, cfg.input_w - 1, cfg.feat_w, dtype=np.float32).reshape(1, 1, -1)
    x = np.broadcast_to(x, (D, cfg.feat_h, cfg.feat_w))
    y = np.linspace(0, cfg.input_h - 1, cfg.feat_h, dtype=np.float32).reshape(1, -1, 1)
    y = np.broadcast_to(y, (D, cfg.feat_h, cfg.feat_w))
    return np.stack([x, y, d], axis=-1)


def get_lidar_coor(
    cfg: BEVDetConfig,
    sensor2ego: np.ndarray,   # [N, 4, 4] (or [N, 3, 3] rot + sep trans)
    cam2img: np.ndarray,      # [N, 3, 3]
    post_rot: Optional[np.ndarray] = None,   # [N, 3, 3] image-aug rotation
    post_tran: Optional[np.ndarray] = None,  # [N, 3]
    bda: Optional[np.ndarray] = None,        # [3, 3] bev data augmentation
) -> np.ndarray:
    """Frustum points in ego/lidar space: [N, D, Hf, Wf, 3]
    (view_transformer.py:126-168, batchless)."""
    N = sensor2ego.shape[0]
    frustum = make_frustum(cfg)  # [D, H, W, 3]
    if post_rot is None:
        post_rot = np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3))
    if post_tran is None:
        post_tran = np.zeros((N, 3), np.float32)
    if bda is None:
        bda = np.eye(3, dtype=np.float32)

    pts = frustum[None] - post_tran.reshape(N, 1, 1, 1, 3)
    inv_post = np.linalg.inv(post_rot).reshape(N, 1, 1, 1, 3, 3)
    pts = (inv_post @ pts[..., None])[..., 0]
    # un-project: (u*d, v*d, d)
    pts = np.concatenate([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], axis=-1)
    rot = sensor2ego[:, :3, :3]
    tran = sensor2ego[:, :3, 3]
    combine = rot @ np.linalg.inv(cam2img)
    pts = (combine.reshape(N, 1, 1, 1, 3, 3) @ pts[..., None])[..., 0]
    pts = pts + tran.reshape(N, 1, 1, 1, 3)
    pts = (bda.reshape(1, 1, 1, 1, 3, 3) @ pts[..., None])[..., 0]
    return pts.astype(np.float32)


@dataclasses.dataclass
class PoolingRanks:
    ranks_depth: np.ndarray
    ranks_feat: np.ndarray
    ranks_bev: np.ndarray
    interval_starts: np.ndarray
    interval_lengths: np.ndarray


def voxel_pooling_prepare(
    cfg: BEVDetConfig, coor: np.ndarray, pad_to: Optional[int] = None,
    pad_intervals_to: Optional[int] = None,
) -> PoolingRanks:
    """coor [N, D, Hf, Wf, 3] -> sorted rank tensors
    (view_transformer.py:239-330).  `pad_to` pads with rank -1 so the jit
    input shape is static across rigs (the reference bakes one sample's
    ranks into the engine for the same reason)."""
    N, D, H, W, _ = coor.shape
    num_points = N * D * H * W
    ranks_depth = np.arange(num_points, dtype=np.int64)
    ranks_feat = np.arange(num_points // D, dtype=np.int64)
    ranks_feat = np.broadcast_to(ranks_feat.reshape(N, 1, H, W), (N, D, H, W)).reshape(-1)

    lower = np.asarray([cfg.grid_xbound[0], cfg.grid_ybound[0], cfg.grid_zbound[0]])
    interval = np.asarray([cfg.grid_xbound[2], cfg.grid_ybound[2], cfg.grid_zbound[2]])
    gx, gy = cfg.bev_w, cfg.bev_h
    gz = int(round((cfg.grid_zbound[1] - cfg.grid_zbound[0]) / cfg.grid_zbound[2]))

    c = np.floor((coor.reshape(-1, 3) - lower) / interval).astype(np.int64)
    kept = (
        (c[:, 0] >= 0) & (c[:, 0] < gx)
        & (c[:, 1] >= 0) & (c[:, 1] < gy)
        & (c[:, 2] >= 0) & (c[:, 2] < gz)
    )
    c, ranks_depth, ranks_feat = c[kept], ranks_depth[kept], ranks_feat[kept]
    ranks_bev = c[:, 2] * (gy * gx) + c[:, 1] * gx + c[:, 0]
    order = np.argsort(ranks_bev, kind="stable")
    ranks_bev, ranks_depth, ranks_feat = ranks_bev[order], ranks_depth[order], ranks_feat[order]

    first = np.ones(len(ranks_bev), bool)
    first[1:] = ranks_bev[1:] != ranks_bev[:-1]
    interval_starts = np.flatnonzero(first).astype(np.int32)
    interval_lengths = np.diff(np.append(interval_starts, len(ranks_bev))).astype(np.int32)

    def pad(x):
        if pad_to is None:
            return x.astype(np.int32)
        if len(x) > pad_to:
            raise ValueError(
                f"voxel_pooling_prepare: {len(x)} in-grid frustum points exceed "
                f"pad_to={pad_to}; raise pad_to or coarsen the grid (silently "
                "truncating would drop LSS splat contributions)"
            )
        out = np.full(pad_to, -1, np.int32)
        out[: len(x)] = x
        return out

    if pad_intervals_to is not None:
        if len(interval_starts) > pad_intervals_to:
            raise ValueError(
                f"voxel_pooling_prepare: {len(interval_starts)} occupied BEV "
                f"cells exceed pad_intervals_to={pad_intervals_to}"
            )
        s = np.zeros(pad_intervals_to, np.int32)
        l = np.zeros(pad_intervals_to, np.int32)
        s[: len(interval_starts)] = interval_starts
        l[: len(interval_lengths)] = interval_lengths
        interval_starts, interval_lengths = s, l
    return PoolingRanks(
        ranks_depth=pad(ranks_depth),
        ranks_feat=pad(ranks_feat),
        ranks_bev=pad(ranks_bev),
        interval_starts=interval_starts.astype(np.int32),
        interval_lengths=interval_lengths.astype(np.int32),
    )


class LSSViewTransformer(nn.Module):
    """depth_net (1x1 conv -> D + C), a float32 softmax over depth, and the
    BEV splat."""

    def __init__(self, cfg: BEVDetConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.depth_net = QConv(in_channels, cfg.depth_bins + cfg.view_channels, 1, 1, 0,
                               quant=cfg.quant)

    def forward(self, x, ranks_depth, ranks_feat, ranks_bev, interval_starts=None,
                interval_lengths=None):
        """x: [N_cams, C_in, Hf, Wf] image features.  Returns the BEV map
        [1, view_channels, bev_h, bev_w] in the features' dtype.  With
        interval_* given, the splat takes the `interval` formulation
        (ops/bev_pool.py), else `scatter`."""
        cfg = self.cfg
        D = cfg.depth_bins
        out = self.depth_net(x)
        depth = torch.softmax(out[:, :D].float(), dim=1)  # [N, D, Hf, Wf]
        feat = out[:, D:].permute(0, 2, 3, 1)              # [N, Hf, Wf, C]
        bev = bev_pool_v2(depth, feat, ranks_depth, ranks_feat, ranks_bev, interval_starts,
                          interval_lengths, out_height=cfg.bev_h, out_width=cfg.bev_w,
                          impl="scatter" if interval_starts is None else "interval")
        return bev.permute(0, 3, 1, 2)
