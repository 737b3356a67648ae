"""FPN neck, NCHW, mmdet semantics (port of `bevformer_tensorrt_tpu/models/necks/fpn.py`).

Lateral 1x1 convs, nearest 2x top-down pathway, 3x3 output convs, extra
stride-2 convs on the last output for num_outs > len(inputs).
"""
from __future__ import annotations

from typing import List, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..layers import QConv


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, relu_before_extra_convs: bool = True, quant=False):
        super().__init__()
        self.n_in = len(in_channels)
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", QConv(c, out_channels, 1, 1, 0, quant=quant))
        for i in range(num_outs):
            stride = 1 if i < self.n_in else 2
            setattr(self, f"fpn{i}", QConv(out_channels, out_channels, 3, stride, 1,
                                           quant=quant))

    def forward(self, inputs: List) -> List:
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        for i in range(self.n_in - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")
            # crop in case of odd spatial dims
            up = up[:, :, : laterals[i - 1].shape[2], : laterals[i - 1].shape[3]]
            laterals[i - 1] = laterals[i - 1] + up
        outs = [getattr(self, f"fpn{i}")(laterals[i]) for i in range(self.n_in)]
        for i in range(self.n_in, self.num_outs):
            src = outs[-1]
            if i > self.n_in and self.relu_before_extra_convs:
                src = F.relu(src)
            outs.append(getattr(self, f"fpn{i}")(src))
        return outs
