"""ResNet-50 backbone, pytorch style, NCHW (port of
`bevformer_tensorrt_tpu/models/backbones/resnet.py`).

Frozen BatchNorm as an affine; the stride sits on the 3x3 conv.  R101,
caffe style and the DCN stages belong to the small/base slice and are
refused here.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBN, QConv

STAGE_BLOCKS = (3, 4, 6, 3)  # R50


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = QConv(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = QConv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = QConv(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = QConv(inplanes, planes * 4, 1, stride, 0, bias=False)
            self.downsample_bn = FrozenBN(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (3,),
                 dcn_stages: Sequence[bool] = (False,) * 4):
        super().__init__()
        if depth != 50 or any(dcn_stages):
            raise NotImplementedError("only R50 without DCN is ported (small/base come later)")
        self.out_indices = tuple(out_indices)
        self.stem_conv = QConv(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = FrozenBN(64)
        self.blocks = []
        inplanes, planes = 64, 64
        for stage, n in enumerate(STAGE_BLOCKS):
            names = []
            for b in range(n):
                name = f"stage{stage}_block{b}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, stride=(1 if stage == 0 or b > 0 else 2), downsample=(b == 0)))
                inplanes = planes * 4
                names.append(name)
            self.blocks.append(names)
            planes *= 2

    def forward(self, x):
        """x: [N, 3, H, W] -> list of stage features [N, C, h, w]."""
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
