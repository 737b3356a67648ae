"""BEVFormer encoder (port of `bevformer_tensorrt_tpu/models/modules/encoder.py`):
reference points, lidar -> image point sampling, the camera compaction, and
the self/cross attention layer stack.

The per-layer `use_prev_bev` mux is arithmetic, not a branch:
`mux * prev + (1 - mux) * [q, q]`.  The TPU's sigma sort of each camera's
compacted queries only speeds up the TPU kernel and is left out: the
index-add at `topi` puts every query back in its slot whatever the order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ...configs.bevformer import BEVFormerConfig
from ..layers import FFN, LayerNorm
from .attention import (
    SpatialCrossAttention,
    TemporalSelfAttention,
    camera_compaction,
    compaction_size,
)


def get_reference_points_3d(bev_h: int, bev_w: int, num_points_in_pillar: int) -> np.ndarray:
    """Pillar reference points, normalized [0, 1]: [1, pillar, h*w, 3]."""
    Z = num_points_in_pillar
    zs = (np.linspace(0.5, Z - 0.5, Z) / Z)[:, None, None]
    xs = (np.linspace(0.5, bev_w - 0.5, bev_w) / bev_w)[None, None, :]
    ys = (np.linspace(0.5, bev_h - 0.5, bev_h) / bev_h)[None, :, None]
    zs, xs, ys = np.broadcast_arrays(zs, xs, ys)
    ref = np.stack([xs, ys, zs], axis=-1).reshape(1, Z, bev_h * bev_w, 3)
    return ref.astype(np.float32)


def point_sampling(ref_3d, pc_range: Tuple[float, ...], lidar2img,
                   image_shape: Tuple[int, int], num_cams: int):
    """Project pillar reference points into each camera.

    Returns reference_points_cam [cams, nq, pillar*2] (normalized image
    coords) and bev_mask [cams, nq, 1]: per-camera hit weights normalized so
    that the per-query sum over cameras is <= 1."""
    pillar, nq = ref_3d.shape[1], ref_3d.shape[2]
    # per-axis scalars rather than small tensors: no host-to-device copy
    pts = torch.stack([ref_3d[..., i].float() * (pc_range[i + 3] - pc_range[i]) + pc_range[i]
                       for i in range(3)] + [torch.ones_like(ref_3d[..., 0])], dim=-1)

    l2i = lidar2img.reshape(num_cams, 4, 4).float()
    cam = torch.einsum("pqd,ced->pcqe", pts[0], l2i)  # [pillar, cams, nq, 4]

    eps = 1e-5
    z = cam[..., 2:3]
    hit = (z > eps).float()
    xy = cam[..., 0:2] / torch.clamp(z, min=eps)
    xy = torch.stack([xy[..., 0] / image_shape[1], xy[..., 1] / image_shape[0]], dim=-1)

    inb = (hit * (xy[..., 1:2] > 0.0) * (xy[..., 1:2] < 1.0)
           * (xy[..., 0:1] > 0.0) * (xy[..., 0:1] < 1.0))  # [pillar, cams, nq, 1]
    ref_cam = xy.permute(1, 2, 0, 3).reshape(num_cams, nq, pillar * 2)
    mask = 1.0 - torch.prod(1.0 - inb, dim=0)
    mask = mask.reshape(num_cams, nq, 1)
    mask = mask / torch.clamp(mask.sum(dim=0, keepdim=True), min=1e-4)
    return ref_cam, mask


def cam_budget_overflow(cfg, lidar2img: np.ndarray) -> Tuple[np.ndarray, int]:
    """Host-side (numpy) guard for the static camera compaction: visible BEV
    queries per camera, and how far the largest count exceeds K."""
    nq = cfg.bev_h * cfg.bev_w
    K = compaction_size(nq, cfg.cam_budget)
    ref = get_reference_points_3d(cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar)[0]
    span = np.array([cfg.pc_range[3] - cfg.pc_range[0], cfg.pc_range[4] - cfg.pc_range[1],
                     cfg.pc_range[5] - cfg.pc_range[2]], np.float32)
    pts = ref * span + np.asarray(cfg.pc_range[:3], np.float32)
    pts = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    l2i = np.asarray(lidar2img, np.float32).reshape(cfg.num_cams, 4, 4)
    cam = np.einsum("pqd,ced->pcqe", pts, l2i)
    eps = 1e-5
    z = cam[..., 2]
    xy = cam[..., 0:2] / np.maximum(z, eps)[..., None]
    u = xy[..., 0] / cfg.img_w
    v = xy[..., 1] / cfg.img_h
    inb = (z > eps) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
    visible = inb.any(axis=0).sum(axis=1)
    return visible, int(max(0, visible.max() - K))


def encoder_geometry(cfg, ref_3d, lidar2img, shift, use_prev_bev):
    """Frame geometry shared by every encoder layer, from the pillar
    reference points `ref_3d` [1, pillar, nq, 3].  Returns
    (hybrid_ref_2d [2, nq, 1, 2], reference_points_cam [cams, nq, pillar*2],
    bev_mask [cams, nq, 1], compaction or None)."""
    nq = cfg.bev_h * cfg.bev_w
    ref_2d = ref_3d[0, 0, :, :2].reshape(1, nq, 1, 2)
    reference_points_cam, bev_mask = point_sampling(
        ref_3d, cfg.pc_range, lidar2img, (cfg.img_h, cfg.img_w), cfg.num_cams)
    shift_ref_2d = ref_2d + shift.reshape(1, 1, 1, 2) * use_prev_bev
    hybrid_ref_2d = torch.cat([shift_ref_2d, ref_2d], dim=0)
    K = compaction_size(nq, cfg.cam_budget)
    compaction = camera_compaction(bev_mask, reference_points_cam, K) if K < nq else None
    return hybrid_ref_2d, reference_points_cam, bev_mask, compaction


class BEVFormerLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        C = cfg.embed_dims
        self.bev_shape = ((cfg.bev_h, cfg.bev_w),)
        self.self_attn = TemporalSelfAttention(C, cfg.num_heads, 1, cfg.num_points_self,
                                               quant=cfg.quant)
        self.norm1 = LayerNorm(C)
        self.cross_attn = SpatialCrossAttention(
            C, cfg.num_cams, cfg.num_heads, cfg.num_levels, cfg.num_points_cross, cfg.cam_budget,
            quant=cfg.quant)
        self.norm2 = LayerNorm(C)
        self.ffn = FFN(C, cfg.ffn_dims, quant=cfg.quant)
        self.norm3 = LayerNorm(C)

    def forward(self, query, value, bev_pos, hybrid_ref_2d, reference_points_cam, bev_mask,
                spatial_shapes, prev_bev, compaction=None):
        identity = query
        query = self.self_attn(query, prev_bev, identity, bev_pos, hybrid_ref_2d, self.bev_shape)
        query = self.norm1(query)
        identity = query
        query = self.cross_attn(query, value, identity, None, reference_points_cam, bev_mask,
                                spatial_shapes, compaction)
        query = self.norm2(query)
        return self.norm3(self.ffn(query))


class BEVFormerEncoder(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.encoder_layers):
            setattr(self, f"layer{i}", BEVFormerLayer(cfg))
        # frame-invariant, kept on the model's device
        self.register_buffer("ref_3d", torch.from_numpy(get_reference_points_3d(
            cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar)), persistent=False)

    def forward(self, bev_query, value, bev_pos, lidar2img, prev_bev, shift, use_prev_bev,
                spatial_shapes):
        """bev_query [1, nq, C]; value [cams, keys, C]; prev_bev [1, nq, C]
        (already rotated); shift [2]; use_prev_bev scalar 0/1."""
        hybrid_ref_2d, reference_points_cam, bev_mask, compaction = encoder_geometry(
            self.cfg, self.ref_3d, lidar2img, shift, use_prev_bev)
        prev_queue = torch.cat([prev_bev, bev_query], dim=0)  # [2, nq, C]
        output = bev_query
        mux = use_prev_bev.to(output.dtype)
        for i in range(self.cfg.encoder_layers):
            cur_stack = torch.cat([output, output], dim=0)
            layer_prev = mux * prev_queue.to(output.dtype) + (1 - mux) * cur_stack
            output = getattr(self, f"layer{i}")(
                output, value, bev_pos, hybrid_ref_2d, reference_points_cam, bev_mask,
                spatial_shapes, layer_prev, compaction)
        return output
