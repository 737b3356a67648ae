"""BEVDet detector: image backbone and neck -> LSS view transformer -> BEV
encoder -> CenterPoint head, NCHW (port of
`bevformer_tensorrt_tpu/models/detectors/bevdet.py`).

The reference's BEVDetTRT forward (det2trt/models/detector/bevdet.py:33-95:
backbone -> CustomFPN -> depth-net softmax -> bev_pool_v2 -> CustomResNet +
FPN_LSS -> CenterHead), with the rank tensors made on the host from the rig
(`models/necks/view_transformer.py`).

`cfg.quant` selects the quantized tiers (True: QDQ simulation; "int8": every
convolution on the int8 product) and `cfg.quant_exclude` the policy, resolved
into every site once, here, when the model is built.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...configs.bevdet import BEVDetConfig
from ...quant.policy import set_quant_exclude
from ..backbones.bev_resnet import FPN_LSS, CustomResNet
from ..backbones.resnet import ResNet
from ..heads.centerpoint_head import CenterHead
from ..layers import QConv
from ..necks.view_transformer import LSSViewTransformer


class CustomFPN(nn.Module):
    """mmdet CustomFPN with out_ids=[0]: the top-down pathway over the
    inputs, then one 3x3 conv on the finest (bevdet-r50-cbgs.py:92-99)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, quant=False):
        super().__init__()
        self.n_in = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", QConv(c, out_channels, 1, 1, 0, quant=quant))
        self.fpn0 = QConv(out_channels, out_channels, 3, 1, 1, quant=quant)

    def forward(self, inputs):
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        for i in range(self.n_in - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")
            up = up[:, :, : laterals[i - 1].shape[2], : laterals[i - 1].shape[3]]
            laterals[i - 1] = laterals[i - 1] + up
        return self.fpn0(laterals[0])


class BEVDet(nn.Module):
    def __init__(self, cfg: BEVDetConfig):
        super().__init__()
        if cfg.quant not in (False, True, "int8"):
            raise ValueError(f"quant {cfg.quant!r}: expected False, True or 'int8'")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: expected 'float32' or 'bfloat16'")
        self.cfg = cfg
        self.img_backbone = ResNet(cfg.backbone_depth, cfg.backbone_out_indices, style="pytorch",
                                   quant=cfg.quant)
        in_ch = [256 * 2 ** i for i in cfg.backbone_out_indices]
        self.img_neck = CustomFPN(in_ch, cfg.neck_out_channels, quant=cfg.quant)
        self.img_view_transformer = LSSViewTransformer(cfg, cfg.neck_out_channels)
        self.img_bev_encoder_backbone = CustomResNet(cfg.view_channels, cfg.bev_channels,
                                                     quant=cfg.quant)
        self.img_bev_encoder_neck = FPN_LSS(cfg.bev_channels[0] + cfg.bev_channels[2],
                                            cfg.bev_out_channels, quant=cfg.quant)
        self.pts_bbox_head = CenterHead(cfg, cfg.bev_out_channels)
        set_quant_exclude(self, cfg.quant_exclude)

    def forward(self, image, ranks_depth, ranks_feat, ranks_bev, interval_starts=None,
                interval_lengths=None) -> Dict[str, torch.Tensor]:
        """
        Args:
          image: [1, cams, 3, H, W] normalized input.
          ranks_*: [P] integer pooling ranks (-1 pads).
          interval_*: optional [I] segment boundaries: the `interval` splat.
        Returns:
          the CenterHead maps, NCHW, in the compute dtype.
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        bs, cams = image.shape[:2]
        img = image.reshape(bs * cams, 3, cfg.input_h, cfg.input_w).to(dtype)
        x = self.img_neck(self.img_backbone(img))
        bev = self.img_view_transformer(x, ranks_depth, ranks_feat, ranks_bev, interval_starts,
                                        interval_lengths).to(dtype)
        bev = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(bev))
        return self.pts_bbox_head(bev)
