"""CenterNet detector: ResNet-18 -> CTResNetNeck -> CenterNetHead, NCHW
(port of `bevformer_tensorrt_tpu/models/detectors/centernet.py`).

The reference's CenterNetTRT (det2trt/models/detector/centernet.py :7-34).
Takes a batch of images; the head maps are at stride 4.  Under
`dtype="bfloat16"` the backbone and the first DCN run bfloat16 and the rest
float32, as in the JAX package (`necks/ct_resnet_neck.py`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ...configs.centernet import CenterNetConfig
from ...quant.policy import set_quant_exclude
from ..backbones.resnet import ResNet
from ..heads.centernet_head import CenterNetHead
from ..necks.ct_resnet_neck import CTResNetNeck
from .yolox import check_config


class CenterNet(nn.Module):
    def __init__(self, cfg: CenterNetConfig):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone_depth, out_indices=(3,), quant=cfg.quant)
        self.neck = CTResNetNeck(512, cfg.deconv_filters, cfg.use_dcn, quant=cfg.quant)
        self.bbox_head = CenterNetHead(cfg.deconv_filters[-1], cfg.num_classes,
                                       cfg.deconv_filters[-1], quant=cfg.quant)
        set_quant_exclude(self, cfg.quant_exclude)

    def forward(self, image) -> Dict[str, torch.Tensor]:
        """image: [N, 3, H, W] -> {heatmap, wh, offset} maps, NCHW."""
        x = image.to(getattr(torch, self.cfg.dtype))
        return self.bbox_head(self.neck(self.backbone(x)[0]))
