"""YOLOX decoupled head and its decode, NCHW (port of
`bevformer_tensorrt_tpu/models/heads/yolox_head.py`).

mmdet's YOLOXHead as the reference deploys it
(det2trt/models/detector/yolox.py YOLOXTRT forward_trt :41-80: cls / reg /
obj maps per level; the QAT variant quantizes the predictor convs,
det2trt/models/dense_heads/yolox_head.py:39-47).  The decode (grid and
stride unmapping, sigmoid(obj) x sigmoid(cls) scores) runs on the device;
the class-aware NMS on the host (`core/nms2d.py`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.nms2d import multiclass_nms
from ..backbones.csp_darknet import ConvModule
from ..layers import QConv


class YOLOXHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80, feat_channels: int = 320,
                 stacked_convs: int = 2, strides: Tuple[int, ...] = (8, 16, 32), quant=False):
        super().__init__()
        self.strides = tuple(strides)
        self.stacked_convs = stacked_convs
        for lvl in range(len(self.strides)):
            for branch in ("cls", "reg"):
                cin = in_channels
                for i in range(stacked_convs):
                    setattr(self, f"l{lvl}_{branch}{i}",
                            ConvModule(cin, feat_channels, 3, quant=quant))
                    cin = feat_channels
            setattr(self, f"l{lvl}_cls_out", QConv(feat_channels, num_classes, 1, quant=quant))
            setattr(self, f"l{lvl}_reg_out", QConv(feat_channels, 4, 1, quant=quant))
            setattr(self, f"l{lvl}_obj_out", QConv(feat_channels, 1, 1, quant=quant))

    def forward(self, feats: List[torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        outs = []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for i in range(self.stacked_convs):
                cls_feat = getattr(self, f"l{lvl}_cls{i}")(cls_feat)
                reg_feat = getattr(self, f"l{lvl}_reg{i}")(reg_feat)
            outs.append({"cls": getattr(self, f"l{lvl}_cls_out")(cls_feat),
                         "reg": getattr(self, f"l{lvl}_reg_out")(reg_feat),
                         "obj": getattr(self, f"l{lvl}_obj_out")(reg_feat)})
        return outs


def yolox_decode(outs: Sequence[Dict[str, torch.Tensor]], strides: Sequence[int] = (8, 16, 32)):
    """Batch decode to (boxes xyxy [n, P, 4], scores [n, P, C]), float32,
    the points of each level in row-major (y, x) order: mmdet's
    YOLOXHead._bbox_decode, xy = (pred[:2] + grid) * stride,
    wh = exp(pred[2:4]) * stride."""
    boxes_all, scores_all = [], []
    for o, s in zip(outs, strides):
        n, C, h, w = o["cls"].shape
        dev = o["cls"].device
        gx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)
        gy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
        reg = o["reg"].float().permute(0, 2, 3, 1)
        cx = (reg[..., 0:1] + gx) * s
        cy = (reg[..., 1:2] + gy) * s
        bw = torch.exp(reg[..., 2:3]) * s
        bh = torch.exp(reg[..., 3:4]) * s
        boxes = torch.cat([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
        score = torch.sigmoid(o["cls"].float()) * torch.sigmoid(o["obj"].float())
        boxes_all.append(boxes.reshape(n, h * w, 4))
        scores_all.append(score.permute(0, 2, 3, 1).reshape(n, h * w, C))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def yolox_post_process(boxes: np.ndarray, scores: np.ndarray, score_thr: float = 0.01,
                       iou_threshold: float = 0.65, max_per_img: int = 100):
    """Host-side class-aware NMS of one image's decode (mmdet
    multiclass_nms): (boxes [k, 4], scores [k], labels [k])."""
    return multiclass_nms(np.asarray(boxes), np.asarray(scores), score_thr, iou_threshold,
                          max_per_img)
