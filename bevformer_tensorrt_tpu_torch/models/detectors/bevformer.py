"""BEVFormer detector: backbone -> FPN -> BEVFormerHead
(port of `bevformer_tensorrt_tpu/models/detectors/bevformer.py`).

One forward of (image, prev_bev, use_prev_bev, can_bus, lidar2img) ->
(bev_embed, outputs_classes, outputs_coords) with bs = 1.  The recurrent
prev_bev / can_bus state lives in `runtime/engine.py`.

`cfg.quant` selects the quantized tiers (True: QDQ simulation; "int8": real
int8 execution) and `cfg.quant_exclude` the mixed-precision policy, which is
resolved into every site once, here, when the model is built.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...configs.bevformer import BEVFormerConfig
from ...quant.policy import set_quant_exclude
from ..backbones.resnet import ResNet
from ..heads.bevformer_head import BEVFormerHead
from ..necks.fpn import FPN


class BEVFormer(nn.Module):
    def __init__(self, cfg: BEVFormerConfig):
        super().__init__()
        if cfg.quant not in (False, True, "int8"):
            raise ValueError(f"quant {cfg.quant!r}: expected False, True or 'int8'")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: expected 'float32' or 'bfloat16'")
        self.cfg = cfg
        style = "caffe" if cfg.backbone_depth == 101 else "pytorch"
        self.img_backbone = ResNet(cfg.backbone_depth, cfg.backbone_out_indices, cfg.dcn_stages,
                                   style, quant=cfg.quant)
        in_ch = [256 * 2 ** i for i in cfg.backbone_out_indices]
        self.img_neck = FPN(in_ch, cfg.embed_dims, cfg.num_levels, quant=cfg.quant)
        self.pts_bbox_head = BEVFormerHead(cfg)
        set_quant_exclude(self, cfg.quant_exclude)

    def forward(self, image, prev_bev, use_prev_bev, can_bus, lidar2img):
        """
        Args:
          image:        [1, cams, 3, H, W] (NCHW)
          prev_bev:     [bev_h*bev_w, 1, C]
          use_prev_bev: scalar 0/1 tensor
          can_bus:      [18]
          lidar2img:    [1, cams, 4, 4]
        Returns:
          bev_embed [nq, 1, C], outputs_classes [L, 1, num_query, classes],
          outputs_coords [L, 1, num_query, code_size], all float32.
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        bs, cams = image.shape[:2]
        img = image.reshape(bs * cams, 3, cfg.img_h, cfg.img_w).to(dtype)
        feats = self.img_neck(self.img_backbone(img))
        mlvl = [f.reshape(bs, cams, *f.shape[1:]) for f in feats]
        return self.pts_bbox_head(
            mlvl, prev_bev, can_bus.reshape(-1).float(), lidar2img,
            torch.as_tensor(use_prev_bev, dtype=torch.float32, device=image.device).reshape(()))
