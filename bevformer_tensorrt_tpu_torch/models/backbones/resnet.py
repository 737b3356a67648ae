"""ResNet-50/101 backbone with optional DCNv2 stages, NCHW (port of
`bevformer_tensorrt_tpu/models/backbones/resnet.py`).

Frozen BatchNorm as an affine.  Style "pytorch" puts a block's stride on the
3x3 conv (R50 at tiny), "caffe" on the first 1x1 (R101 at small and base).
In a DCN stage the 3x3 conv is `DeformConv2d`: a plain conv predicts offsets
and mask, `ops.dcn.modulated_deform_conv2d` samples.

Under `quant` every conv is a quantization site and the identity branch of
a block passes the QDQ site `qdq_residual` ahead of the residual add.  R18
and R34 (CenterNet's backbone) are built of two-conv basic blocks.  The
DCN op itself ignores `quant` unless it is "int8": then it samples from the
int8 gather table of the im2col, unless the policy excludes the pseudo-site
`<conv2>/dcn_tables`, which keeps the table in floating point.
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

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BASIC_DEPTHS = (18, 34)


class DeformConv2d(nn.Module):
    """DCNv2 3x3 block, no bias on the deformable conv.  `conv_offset`
    emits dg*27 channels in mmcv's layout: the first 2*ntap are the offsets,
    per tap interleaved (2t = y, 2t+1 = x), the last ntap the mask logits.
    Under "int8" the op samples from the int8 table of `x` (`int8_table`,
    resolved under the policy at the site `<module>/dcn_tables`).  The op's
    weight matrix (`dcn_weight_matrix`) is kept per activation dtype and
    made again when the weight is replaced or changed in place through
    autograd's view of it (its version moves), when a state_dict is loaded
    and when the module is moved or cast.  An edit through `weight.data`
    leaves the version as it was: call `invalidate()` after one."""

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
        self._wmats: dict = {}  # dtype -> (the weight's identity, its matrix)

    def resolve_quant(self, path, exclude) -> None:
        self.path = tuple(path)
        self.int8_table = effective_quant(
            self.quant, self.path + ("dcn_tables",), exclude) == "int8"

    def _load_from_state_dict(self, state_dict, prefix, *args):
        self._wmats = {}
        super()._load_from_state_dict(state_dict, prefix, *args)

    def _apply(self, fn, *args, **kwargs):
        self._wmats = {}
        return super()._apply(fn, *args, **kwargs)

    def invalidate(self):
        """Drops the kept weight matrices (after an edit of the weight that
        its version does not see, such as one through `weight.data`)."""
        self._wmats = {}

    def weight_matrix(self, dtype):
        """`dcn_weight_matrix(self.weight, dtype)`, made once per dtype and
        weight state."""
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        kept = self._wmats.get(dtype)
        if kept is None or kept[0] != key:
            with torch.no_grad():
                kept = (key, dcn_ops.dcn_weight_matrix(w, dtype))
            self._wmats[dtype] = kept
        return kept[1]

    def forward(self, x):
        ntap = self.deform_groups * 9
        off_mask = self.conv_offset(x)
        offset = off_mask[:, : 2 * ntap].contiguous()
        mask = torch.sigmoid(off_mask[:, 2 * ntap:]).contiguous()
        # the fused kernel's operand: bfloat16 maps and int8 tables (float32
        # maps take the im2col route, which multiplies by the weight itself)
        fused = x.is_cuda and (x.dtype != torch.float32 or self.int8_table)
        wmat = self.weight_matrix(x.dtype) if fused else None
        return dcn_ops.modulated_deform_conv2d(
            x.contiguous(), offset, mask, self.weight, None, stride=self.stride, padding=1,
            dilation=1, groups=1, deform_groups=self.deform_groups, layout="NCHW",
            quant="int8" if self.int8_table else False, wmat=wmat)


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


class ResNetBasicBlock(nn.Module):
    """Two-conv residual block of R18 / R34; a stage's first block (after
    the first stage) downsamples its identity with a strided 1x1 conv."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 quant=False):
        super().__init__()
        self.conv1 = QConv(inplanes, planes, 3, stride, 1, bias=False, quant=quant)
        self.bn1 = FrozenBN(planes)
        self.conv2 = QConv(planes, planes, 3, 1, 1, bias=False, quant=quant)
        self.bn2 = FrozenBN(planes)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = QConv(inplanes, planes, 1, stride, 0, bias=False, quant=quant)
            self.downsample_bn = FrozenBN(planes)
        self.qdq_residual = QDQ() if quant else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
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
            raise NotImplementedError(f"ResNet depth {depth}: expected one of {sorted(STAGE_BLOCKS)}")
        basic = depth in BASIC_DEPTHS
        self.out_indices = tuple(out_indices)
        self.stem_conv = QConv(3, 64, 7, 2, 3, bias=False, quant=quant)
        self.stem_bn = FrozenBN(64)
        self.blocks = []
        inplanes, planes = 64, 64
        for stage, n in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n):
                name = f"stage{stage}_block{b}"
                stride = 1 if stage == 0 or b > 0 else 2
                if basic:
                    block = ResNetBasicBlock(inplanes, planes, stride,
                                             downsample=(b == 0 and stage > 0), quant=quant)
                else:
                    block = Bottleneck(inplanes, planes, stride=stride, downsample=(b == 0),
                                       style=style, dcn=bool(dcn_stages[stage]), quant=quant)
                setattr(self, name, block)
                inplanes = planes * (1 if basic else 4)
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
