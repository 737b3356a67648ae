"""CSPDarknet backbone for YOLOX, NCHW (port of
`bevformer_tensorrt_tpu/models/backbones/csp_darknet.py`).

mmdet's CSPDarknet as the reference configures it
(configs/yolox/yolox_x_8x8_300e_coco.py: deepen_factor 1.33, widen_factor
1.25) and its QAT variant (residual quantizers in
det2trt/models/utils/scp_layer.py:66-79): a Focus stem (space-to-depth, then
a conv), four CSP stages (the last with SPP), SiLU activations.  Every conv
is a `QConv`, so the QDQ and int8 tiers come with it; under `quant` the
identity of a bottleneck passes the QDQ site `qdq_residual`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...quant.qdq import QDQ
from ..layers import FrozenBN, QConv

# the P5 arch: (channels, blocks, SPP) of stages 1-4, before the factors
STAGES = ((128, 3, False), (256, 9, False), (512, 9, False), (1024, 3, True))


def silu(x):
    return x * torch.sigmoid(x)


class ConvModule(nn.Module):
    """conv (no bias) + frozen BN + SiLU; padding (k - 1) // 2."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1, stride: int = 1,
                 quant=False):
        super().__init__()
        self.conv = QConv(in_channels, features, kernel, stride, (kernel - 1) // 2, bias=False,
                          quant=quant)
        self.bn = FrozenBN(features)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


class DarknetBottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, add_identity: bool = True, quant=False):
        super().__init__()
        self.conv1 = ConvModule(in_channels, features, 1, quant=quant)
        self.conv2 = ConvModule(features, features, 3, quant=quant)
        self.add_identity = add_identity and in_channels == features
        self.qdq_residual = QDQ() if quant and self.add_identity else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if not self.add_identity:
            return out
        identity = x if self.qdq_residual is None else self.qdq_residual(x)[0]
        return out + identity


class CSPLayer(nn.Module):
    def __init__(self, in_channels: int, features: int, num_blocks: int = 1,
                 add_identity: bool = True, quant=False):
        super().__init__()
        mid = features // 2
        self.main_conv = ConvModule(in_channels, mid, 1, quant=quant)
        self.short_conv = ConvModule(in_channels, mid, 1, quant=quant)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"block{i}", DarknetBottleneck(mid, mid, add_identity, quant=quant))
        self.final_conv = ConvModule(2 * mid, features, 1, quant=quant)

    def forward(self, x):
        main = self.main_conv(x)
        short = self.short_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"block{i}")(main)
        return self.final_conv(torch.cat([main, short], dim=1))


def space_to_depth(x):
    """[N, C, H, W] -> [N, 4C, H/2, W/2] in the JAX order: (even rows, even
    columns), (odd, even), (even, odd), (odd, odd)."""
    return torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
                      x[:, :, 1::2, 1::2]], dim=1)


class Focus(nn.Module):
    """Space-to-depth stem, then a conv."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, quant=False):
        super().__init__()
        self.conv = ConvModule(4 * in_channels, features, kernel, quant=quant)

    def forward(self, x):
        return self.conv(space_to_depth(x))


class SPPBottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 pool_sizes: Tuple[int, ...] = (5, 9, 13), quant=False):
        super().__init__()
        mid = in_channels // 2
        self.pool_sizes = tuple(pool_sizes)
        self.conv1 = ConvModule(in_channels, mid, 1, quant=quant)
        self.conv2 = ConvModule(mid * (len(pool_sizes) + 1), features, 1, quant=quant)

    def forward(self, x):
        x = self.conv1(x)
        pools = [x] + [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in self.pool_sizes]
        return self.conv2(torch.cat(pools, dim=1))


class CSPDarknet(nn.Module):
    """arch P5: stages (64, 128, 3), (128, 256, 9), (256, 512, 9),
    (512, 1024, 3, SPP), scaled by the deepen and widen factors."""

    def __init__(self, deepen_factor: float = 1.33, widen_factor: float = 1.25,
                 out_indices: Sequence[int] = (2, 3, 4), quant=False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        w = lambda c: int(c * widen_factor)  # noqa: E731
        d = lambda n: max(round(n * deepen_factor), 1)  # noqa: E731
        self.stem = Focus(3, w(64), quant=quant)
        prev = w(64)
        self.out_channels = []
        for i, (ch, n, spp) in enumerate(STAGES, start=1):
            ch = w(ch)
            setattr(self, f"stage{i}_down", ConvModule(prev, ch, 3, 2, quant=quant))
            if spp:
                setattr(self, f"stage{i}_spp", SPPBottleneck(ch, ch, quant=quant))
            setattr(self, f"stage{i}_csp", CSPLayer(ch, ch, d(n), add_identity=not spp,
                                                    quant=quant))
            if i in self.out_indices:
                self.out_channels.append(ch)
            prev = ch

    def forward(self, x):
        """x: [N, 3, H, W] -> the features of `out_indices`, NCHW."""
        outs = []
        x = self.stem(x)
        if 0 in self.out_indices:
            outs.append(x)
        for i, (_, _, spp) in enumerate(STAGES, start=1):
            x = getattr(self, f"stage{i}_down")(x)
            if spp:
                x = getattr(self, f"stage{i}_spp")(x)
            x = getattr(self, f"stage{i}_csp")(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
