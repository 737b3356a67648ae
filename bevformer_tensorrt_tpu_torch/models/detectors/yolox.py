"""YOLOX detector: CSPDarknet -> PAFPN -> decoupled head, NCHW (port of
`bevformer_tensorrt_tpu/models/detectors/yolox.py`).

The reference's YOLOXTRT forward (det2trt/models/detector/yolox.py :41-80:
3 levels x {cls, reg, obj}); the decode and the class-aware NMS are in
`heads/yolox_head.py`.  Takes a batch of images.  `cfg.quant` selects the
quantized tiers and `cfg.quant_exclude` the policy, resolved into every site
once, here, when the model is built.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from ...configs.yolox import YOLOXConfig
from ...quant.policy import set_quant_exclude
from ..backbones.csp_darknet import CSPDarknet
from ..heads.yolox_head import YOLOXHead
from ..necks.pafpn import YOLOXPAFPN


def check_config(cfg) -> None:
    if cfg.quant not in (False, True, "int8"):
        raise ValueError(f"quant {cfg.quant!r}: expected False, True or 'int8'")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype {cfg.dtype!r}: expected 'float32' or 'bfloat16'")


class YOLOX(nn.Module):
    def __init__(self, cfg: YOLOXConfig):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.backbone = CSPDarknet(cfg.deepen_factor, cfg.widen_factor, quant=cfg.quant)
        self.neck = YOLOXPAFPN(self.backbone.out_channels, cfg.neck_channels,
                               cfg.num_csp_blocks, quant=cfg.quant)
        self.bbox_head = YOLOXHead(cfg.neck_channels, cfg.num_classes, cfg.neck_channels,
                                   quant=cfg.quant)
        set_quant_exclude(self, cfg.quant_exclude)

    def forward(self, image) -> List[Dict[str, torch.Tensor]]:
        """image: [N, 3, H, W] -> per level {cls, reg, obj} maps, NCHW, in
        the compute dtype."""
        x = image.to(getattr(torch, self.cfg.dtype))
        return self.bbox_head(self.neck(self.backbone(x)))
