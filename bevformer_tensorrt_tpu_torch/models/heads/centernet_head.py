"""CenterNet head and its decode, NCHW (port of
`bevformer_tensorrt_tpu/models/heads/centernet_head.py`).

mmdet's CenterNetHead as the reference deploys it
(det2trt/models/detector/centernet.py CenterNetTRT :7-34; the QAT variant
det2trt/models/dense_heads/centernet_head.py:28-39): three branches
(heatmap C, wh 2, offset 2) of a 3x3 conv, ReLU and a 1x1 conv, all with
bias.  The decode is a 3x3 local-maximum suppression on the sigmoid heatmap
and a static top-k, on the device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import QConv

BRANCHES = ("heatmap", "wh", "offset")
HEATMAP_PRIOR = -2.19  # mmdet bias_init_with_prob(0.1), the heatmap's initial bias


class CenterNetHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80, feat_channels: int = 64,
                 quant=False):
        super().__init__()
        for name, out_ch in zip(BRANCHES, (num_classes, 2, 2)):
            setattr(self, f"{name}_conv", QConv(in_channels, feat_channels, 3, 1, 1, quant=quant))
            setattr(self, f"{name}_out", QConv(feat_channels, out_ch, 1, quant=quant))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, f"{name}_out")(F.relu(getattr(self, f"{name}_conv")(x)))
                for name in BRANCHES}


def centernet_decode(heads: Dict[str, torch.Tensor], k: int = 100, kernel: int = 3,
                     stride: int = 4):
    """mmdet's CenterNetHead.decode_heatmap: the local maxima of the sigmoid
    heatmap (max-pool equality), the top k over (class, y, x) class-major,
    wh and offset gathered there, boxes in input pixels.  Ties keep the
    lower index first, as `jax.lax.top_k`: a stable descending sort.
    Returns (boxes [n, k, 4] xyxy, scores [n, k], labels [n, k]), float32
    and int64."""
    heat = torch.sigmoid(heads["heatmap"].float())  # [n, C, H, W]
    hmax = F.max_pool2d(heat, kernel, stride=1, padding=kernel // 2)
    heat = torch.where(hmax == heat, heat, torch.zeros_like(heat))
    n, C, H, W = heat.shape
    scores, idx = torch.sort(heat.reshape(n, -1), dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    labels = idx // (H * W)
    spatial = idx % (H * W)
    ys = (spatial // W).float()
    xs = (spatial % W).float()

    def gather(name):
        v = heads[name].float().permute(0, 2, 3, 1).reshape(n, H * W, -1)
        return torch.gather(v, 1, spatial[..., None].expand(-1, -1, v.shape[-1]))

    wh, off = gather("wh"), gather("offset")
    cx = (xs + off[..., 0]) * stride
    cy = (ys + off[..., 1]) * stride
    bw = wh[..., 0] * stride
    bh = wh[..., 1] * stride
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    return boxes, scores, labels
