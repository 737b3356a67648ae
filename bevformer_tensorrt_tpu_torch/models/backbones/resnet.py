"""ResNet-50/101 backbone with optional DCNv2 stages, NCHW (port of
`bevformer_tensorrt_tpu/models/backbones/resnet.py`).

Frozen BatchNorm as an affine.  Style "pytorch" puts a block's stride on the
3x3 conv (R50 at tiny), "caffe" on the first 1x1 (R101 at small and base).
In a DCN stage the 3x3 conv is `DeformConv2d`: a plain conv predicts offsets
and mask, `ops.dcn.modulated_deform_conv2d` samples.  The R18/R34 basic
blocks of the JAX module belong to CenterNet and are not ported yet.

Under `quant` every conv is a quantization site and the identity branch of
a block passes the QDQ site `qdq_residual` ahead of the residual add.  The
DCN op itself ignores `quant` unless it is "int8": the int8 gather table of
the im2col (pseudo-site `<conv2>/dcn_tables`) is not ported, so a DCN block
under "int8" raises unless the policy excludes `dcn_tables`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import dcn as dcn_ops
from ...quant.policy import effective_quant
from ...quant.qdq import QDQ
from ..layers import FrozenBN, QConv

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class DeformConv2d(nn.Module):
    """DCNv2 3x3 block, no bias on the deformable conv.  `conv_offset`
    emits dg*27 channels in mmcv's layout: the first 2*ntap are the offsets,
    per tap interleaved (2t = y, 2t+1 = x), the last ntap the mask logits."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 deform_groups: int = 1, quant=False):
        super().__init__()
        self.stride = stride
        self.deform_groups = deform_groups
        self.quant = quant
        self.path: tuple = ()
        self.int8_table = quant == "int8"
        self.conv_offset = QConv(in_channels, deform_groups * 27, 3, stride, 1, quant=quant)
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))

    def _refuse_int8_table(self) -> None:
        if self.int8_table:
            raise NotImplementedError(
                f"DeformConv2d '{'/'.join(self.path)}': the int8 gather table of the DCN "
                "im2col (quant='int8' at the site '<module>/dcn_tables') is not ported yet "
                "(ROADMAP.md queue 2, the int8 DCN table); add 'dcn_tables' to quant_exclude "
                "to keep this table in floating point")

    def resolve_quant(self, path, exclude) -> None:
        self.path = tuple(path)
        self.int8_table = effective_quant(
            self.quant, self.path + ("dcn_tables",), exclude) == "int8"
        self._refuse_int8_table()

    def forward(self, x):
        self._refuse_int8_table()
        ntap = self.deform_groups * 9
        off_mask = self.conv_offset(x)
        offset = off_mask[:, : 2 * ntap].contiguous()
        mask = torch.sigmoid(off_mask[:, 2 * ntap:]).contiguous()
        return dcn_ops.modulated_deform_conv2d(
            x.contiguous(), offset, mask, self.weight, None, stride=self.stride, padding=1,
            dilation=1, groups=1, deform_groups=self.deform_groups, layout="NCHW")


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 style: str = "pytorch", dcn: bool = False, quant=False):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"style {style!r}: expected 'pytorch' or 'caffe'")
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = QConv(inplanes, planes, 1, s1, 0, bias=False, quant=quant)
        self.bn1 = FrozenBN(planes)
        if dcn:
            self.conv2 = DeformConv2d(planes, planes, s2, quant=quant)
        else:
            self.conv2 = QConv(planes, planes, 3, s2, 1, bias=False, quant=quant)
        self.bn2 = FrozenBN(planes)
        self.conv3 = QConv(planes, planes * 4, 1, 1, 0, bias=False, quant=quant)
        self.bn3 = FrozenBN(planes * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = QConv(inplanes, planes * 4, 1, stride, 0, bias=False,
                                         quant=quant)
            self.downsample_bn = FrozenBN(planes * 4)
        self.qdq_residual = QDQ() if quant else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        if self.qdq_residual is not None:
            identity = self.qdq_residual(identity)[0]
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 101, out_indices: Sequence[int] = (1, 2, 3),
                 dcn_stages: Sequence[bool] = (False,) * 4, style: str = "pytorch",
                 quant=False):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise NotImplementedError(
                f"ResNet depth {depth}: only the bottleneck depths {sorted(STAGE_BLOCKS)} are ported")
        self.out_indices = tuple(out_indices)
        self.stem_conv = QConv(3, 64, 7, 2, 3, bias=False, quant=quant)
        self.stem_bn = FrozenBN(64)
        self.blocks = []
        inplanes, planes = 64, 64
        for stage, n in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n):
                name = f"stage{stage}_block{b}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, stride=(1 if stage == 0 or b > 0 else 2),
                    downsample=(b == 0), style=style, dcn=bool(dcn_stages[stage]),
                    quant=quant))
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
