"""BEV-space encoder: CustomResNet (BasicBlock stages) and the FPN_LSS neck,
NCHW (port of `bevformer_tensorrt_tpu/models/backbones/bev_resnet.py`).

The reference's BEVDet BEV encoder (third_party/bev_mmdet3d/models/backbones/
resnet.py CustomResNet: 3 stages of 2 BasicBlocks, stride 2 each; and
models/necks/lss_fpn.py FPN_LSS: the deepest stage upsampled x4 bilinear
with aligned corners, concatenated after stage 0, two 3x3 conv + BN + ReLU,
then x2 upsample, 3x3 and 1x1).  BatchNorm is the frozen affine.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBN, QConv


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, quant=False):
        super().__init__()
        self.conv1 = QConv(inplanes, planes, 3, stride, 1, bias=False, quant=quant)
        self.bn1 = FrozenBN(planes)
        self.conv2 = QConv(planes, planes, 3, 1, 1, bias=False, quant=quant)
        self.bn2 = FrozenBN(planes)
        self.has_downsample = stride != 1 or inplanes != planes
        if self.has_downsample:
            # the reference's downsample is a bare 3x3 conv with a bias and no
            # norm (bev_resnet.py:63-71), imported weight for weight
            self.downsample_conv = QConv(inplanes, planes, 3, stride, 1, bias=True, quant=quant)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_conv(x) if self.has_downsample else x
        return F.relu(out + identity)


class CustomResNet(nn.Module):
    """Stages of `blocks_per_stage` BasicBlocks, stride 2 each; returns every
    stage's output."""

    def __init__(self, in_channels: int, num_channels: Sequence[int] = (128, 256, 512),
                 blocks_per_stage: int = 2, quant=False):
        super().__init__()
        self.names = []
        cin = in_channels
        for s, ch in enumerate(num_channels):
            stage = []
            for b in range(blocks_per_stage):
                name = f"stage{s}_block{b}"
                setattr(self, name, BasicBlock(cin if b == 0 else ch, ch,
                                               stride=2 if b == 0 else 1, quant=quant))
                stage.append(name)
            self.names.append(stage)
            cin = ch

    def forward(self, x):
        outs = []
        for stage in self.names:
            for name in stage:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def upsample_bilinear(x, scale: int):
    """Bilinear upsampling with aligned corners (FPN_LSS's nn.Upsample,
    lss_fpn.py:26-28): output pixel i samples input i * (in - 1) / (out - 1).
    The half-pixel form differs (the JAX module measured 0.78 at most on a
    ramp)."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=True)


class FPN_LSS(nn.Module):
    """lss_fpn.py:11-90: concat(stage 0, up4(deepest)) -> two 3x3 convs ->
    up2 -> 3x3 -> 1x1."""

    def __init__(self, in_channels: int, out_channels: int = 256, quant=False):
        super().__init__()
        ch = out_channels * 2
        self.conv1 = QConv(in_channels, ch, 3, 1, 1, bias=False, quant=quant)
        self.bn1 = FrozenBN(ch)
        self.conv2 = QConv(ch, ch, 3, 1, 1, bias=False, quant=quant)
        self.bn2 = FrozenBN(ch)
        self.up_conv = QConv(ch, out_channels, 3, 1, 1, bias=False, quant=quant)
        self.up_bn = FrozenBN(out_channels)
        self.out_conv = QConv(out_channels, out_channels, 1, 1, 0, bias=True, quant=quant)

    def forward(self, feats):
        x = torch.cat([feats[0], upsample_bilinear(feats[2], 4)], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = upsample_bilinear(x, 2)
        x = F.relu(self.up_bn(self.up_conv(x)))
        return self.out_conv(x)
