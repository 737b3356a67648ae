"""BEVFormerHead (port of `bevformer_tensorrt_tpu/models/heads/bevformer_head.py`):
BEV/object query embeddings, positional encoding, per-level cls/reg
branches, box decode into pc_range."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...configs.bevformer import BEVFormerConfig
from ..layers import LearnedPositionalEncoding, QDense, inverse_sigmoid
from ..modules.transformer import PerceptionTransformer


class ClsBranch(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        C = cfg.embed_dims
        self.fc1 = QDense(C, C, quant=cfg.quant)
        self.ln1 = nn.LayerNorm(C, eps=1e-5)
        self.fc2 = QDense(C, C, quant=cfg.quant)
        self.ln2 = nn.LayerNorm(C, eps=1e-5)
        self.out = QDense(C, cfg.num_classes, quant=cfg.quant)

    def forward(self, x):
        x = F.relu(self.ln1(self.fc1(x)))
        x = F.relu(self.ln2(self.fc2(x)))
        return self.out(x)


class RegBranch(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        C = cfg.embed_dims
        self.fc1 = QDense(C, C, quant=cfg.quant)
        self.fc2 = QDense(C, C, quant=cfg.quant)
        self.out = QDense(C, cfg.code_size, quant=cfg.quant)

    def forward(self, x):
        return self.out(F.relu(self.fc2(F.relu(self.fc1(x)))))


class BEVFormerHead(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        self.cfg = cfg
        nq = cfg.bev_h * cfg.bev_w
        C = cfg.embed_dims
        self.bev_embedding = nn.Parameter(torch.zeros(nq, C))
        self.query_embedding = nn.Parameter(torch.zeros(cfg.num_query, 2 * C))
        self.positional_encoding = LearnedPositionalEncoding(C // 2, cfg.bev_h, cfg.bev_w)
        for i in range(cfg.decoder_layers):
            setattr(self, f"reg_branch{i}", RegBranch(cfg))
            setattr(self, f"cls_branch{i}", ClsBranch(cfg))
        self.transformer = PerceptionTransformer(cfg)

    def forward(self, mlvl_feats, prev_bev, can_bus, lidar2img, use_prev_bev):
        cfg = self.cfg
        nq = cfg.bev_h * cfg.bev_w
        pc = cfg.pc_range
        bev_pos = self.positional_encoding(1).reshape(1, nq, cfg.embed_dims)
        bev_embed, inter_states, init_reference, inter_refs = self.transformer(
            mlvl_feats, self.bev_embedding, self.query_embedding, bev_pos, can_bus, lidar2img,
            prev_bev, use_prev_bev,
            reg_branches=lambda lid, x: getattr(self, f"reg_branch{lid}")(x))

        outputs_classes, outputs_coords = [], []
        for lvl in range(cfg.decoder_layers):
            reference = init_reference if lvl == 0 else inter_refs[lvl - 1]
            reference = inverse_sigmoid(reference.float())
            hs = inter_states[lvl].float()
            cls_out = getattr(self, f"cls_branch{lvl}")(hs)
            tmp = getattr(self, f"reg_branch{lvl}")(hs)
            xy = torch.sigmoid(tmp[..., 0:2] + reference[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + reference[..., 2:3])
            x = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
            y = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
            z = z * (pc[5] - pc[2]) + pc[2]
            outputs_classes.append(cls_out)
            outputs_coords.append(torch.cat([x, y, tmp[..., 2:4], z, tmp[..., 5:]], dim=-1))
        return (bev_embed.reshape(nq, 1, cfg.embed_dims), torch.stack(outputs_classes),
                torch.stack(outputs_coords))
