"""DETR-style detection decoder with iterative box refinement
(port of `bevformer_tensorrt_tpu/models/modules/decoder.py`)."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from ...configs.bevformer import BEVFormerConfig
from ..layers import FFN, LayerNorm, inverse_sigmoid
from .attention import CustomMSDeformableAttention, MultiheadAttention


class DecoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        C = cfg.embed_dims
        self.self_attn = MultiheadAttention(C, cfg.num_heads, quant=cfg.quant)
        self.norm1 = LayerNorm(C)
        self.cross_attn = CustomMSDeformableAttention(C, cfg.num_heads, 1,
                                                      cfg.num_points_decoder, quant=cfg.quant)
        self.norm2 = LayerNorm(C)
        self.ffn = FFN(C, cfg.ffn_dims, quant=cfg.quant)
        self.norm3 = LayerNorm(C)

    def forward(self, query, query_pos, value, reference_points_2d, spatial_shapes):
        identity = query
        query = self.self_attn(query, query, query, identity, query_pos, query_pos)
        query = self.norm1(query)
        identity = query
        query = self.cross_attn(query, value, identity, query_pos, reference_points_2d,
                                spatial_shapes)
        query = self.norm2(query)
        return self.norm3(self.ffn(query))


class DetectionTransformerDecoder(nn.Module):
    """Returns (inter_states [layers, 1, nq, C], inter_refs [layers, 1, nq, 3])."""

    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.decoder_layers):
            setattr(self, f"layer{i}", DecoderLayer(cfg))

    def forward(self, query, query_pos, value, reference_points, reg_branches: Callable):
        """query/query_pos [1, nq, C]; value [1, bev_h*bev_w, C];
        reference_points [1, nq, 3] in sigmoid space;
        reg_branches(lid, x) -> [1, nq, code_size]."""
        cfg = self.cfg
        spatial_shapes = ((cfg.bev_h, cfg.bev_w),)
        inter_states, inter_refs = [], []
        for lid in range(cfg.decoder_layers):
            ref_2d = reference_points[..., :2].reshape(1, -1, 1, 2)
            query = getattr(self, f"layer{lid}")(query, query_pos, value, ref_2d, spatial_shapes)
            tmp = reg_branches(lid, query).float()
            reference_points = torch.sigmoid(torch.cat([
                tmp[..., 0:2] + inverse_sigmoid(reference_points[..., 0:2]),
                tmp[..., 4:5] + inverse_sigmoid(reference_points[..., 2:3]),
            ], dim=-1))
            inter_states.append(query)
            inter_refs.append(reference_points)
        return torch.stack(inter_states), torch.stack(inter_refs)
