"""PerceptionTransformer (port of `bevformer_tensorrt_tpu/models/modules/transformer.py`):
ego-motion shift, prev-BEV rotation, camera/level embeddings, and the
encoder + decoder."""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...configs.bevformer import BEVFormerConfig
from ...ops import rotate
from ..layers import QDense
from .decoder import DetectionTransformerDecoder
from .encoder import BEVFormerEncoder


def can_bus_to_shift(can_bus, grid_length, bev_h: int, bev_w: int, use_shift: bool):
    """Ego-motion BEV shift.  can_bus: [18] float32 -> [2] (x, y).  Keeps the
    reference's branch-free arctan form of atan2."""
    delta_x, delta_y = can_bus[0], can_bus[1]
    ego_angle = can_bus[-2] / np.pi * 180.0
    grid_length_y, grid_length_x = grid_length
    translation_length = torch.sqrt(delta_x ** 2 + delta_y ** 2)
    translation_angle = (
        torch.arctan(delta_y / (delta_x + 1e-8))
        + ((1.0 - torch.sign(delta_x)) / 2.0) * torch.sign(delta_y) * np.pi
    ) / np.pi * 180.0
    bev_angle = ego_angle - translation_angle
    shift_y = translation_length * torch.cos(bev_angle / 180.0 * np.pi) / grid_length_y / bev_h
    shift_x = translation_length * torch.sin(bev_angle / 180.0 * np.pi) / grid_length_x / bev_w
    scale = 1.0 if use_shift else 0.0
    return torch.stack([shift_x * scale, shift_y * scale])


class PerceptionTransformer(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dims
        self.can_bus_fc1 = QDense(cfg.can_bus_dims, C // 2, quant=cfg.quant)
        self.can_bus_fc2 = QDense(C // 2, C, quant=cfg.quant)
        self.can_bus_norm = nn.LayerNorm(C, eps=1e-5)
        self.cams_embeds = nn.Parameter(torch.zeros(cfg.num_cams, C))
        self.level_embeds = nn.Parameter(torch.zeros(cfg.num_levels, C))
        self.encoder = BEVFormerEncoder(cfg)
        self.reference_points = QDense(C, 3, quant=cfg.quant)
        self.decoder = DetectionTransformerDecoder(cfg)

    def forward(self, mlvl_feats: List[torch.Tensor], bev_queries, object_query_embed, bev_pos,
                can_bus, lidar2img, prev_bev, use_prev_bev, reg_branches: Callable):
        """mlvl_feats: per level [1, cams, C, h, w]; bev_queries [nq, C];
        object_query_embed [num_query, 2C]; bev_pos [1, nq, C]; can_bus [18];
        lidar2img [1, cams, 4, 4]; prev_bev [nq, 1, C]; use_prev_bev scalar."""
        cfg = self.cfg
        C = cfg.embed_dims
        nq = cfg.bev_h * cfg.bev_w
        dtype = getattr(torch, cfg.dtype)
        shift = can_bus_to_shift(can_bus, cfg.grid_length, cfg.bev_h, cfg.bev_w, cfg.use_shift)

        if cfg.rotate_prev_bev:
            pb = prev_bev.reshape(cfg.bev_h, cfg.bev_w, C).permute(2, 0, 1)
            pb = rotate(pb, can_bus[-1], cfg.rotate_center, interpolation="nearest")
            prev_bev = pb.permute(1, 2, 0).reshape(1, nq, C)
        else:
            prev_bev = prev_bev.reshape(1, nq, C)

        can_bus_feat = F.relu(self.can_bus_fc1(can_bus.reshape(1, cfg.can_bus_dims)))
        can_bus_feat = self.can_bus_norm(F.relu(self.can_bus_fc2(can_bus_feat)))
        bev_q = bev_queries[None] + can_bus_feat[:, None, :] * (1.0 if cfg.use_can_bus else 0.0)

        flat, spatial_shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            _, cams, c, h, w = feat.shape
            f = feat.reshape(cams, c, h * w).transpose(1, 2).to(dtype)  # NHWC row order
            if cfg.use_cams_embeds:
                f = f + self.cams_embeds[:, None, :].to(dtype)
            f = f + self.level_embeds[lvl][None, None, :].to(dtype)
            flat.append(f)
            spatial_shapes.append((h, w))
        value = torch.cat(flat, dim=1)  # [cams, keys, C]
        spatial_shapes = tuple(spatial_shapes)

        bev_embed = self.encoder(bev_q.to(dtype), value, bev_pos.to(dtype), lidar2img,
                                 prev_bev.to(dtype), shift, use_prev_bev, spatial_shapes)

        query_pos, query = torch.split(object_query_embed[None], C, dim=-1)
        reference_points = torch.sigmoid(self.reference_points(query_pos))  # f32 geometry
        inter_states, inter_refs = self.decoder(
            query.to(dtype), query_pos.to(dtype), bev_embed, reference_points.float(),
            reg_branches)
        return bev_embed.float(), inter_states, reference_points, inter_refs
