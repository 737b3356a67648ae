"""YOLOX PAFPN neck (a top-down and a bottom-up CSP path), NCHW (port of
`bevformer_tensorrt_tpu/models/necks/pafpn.py`).

mmdet's YOLOXPAFPN as the reference configures it
(configs/yolox/yolox_x_8x8_300e_coco.py: in [320, 640, 1280], out 320,
num_csp_blocks 4), with mmdet's channel plan: reduce{k} maps level n-1-k to
the next-lower level's width, and the reduced map is what the bottom-up path
concatenates with.  Module names index mmdet's lists: reduce{k} =
reduce_layers.{k}, td_csp{k} = top_down_blocks.{k}, down{k} =
downsamples.{k}, bu_csp{k} = bottom_up_blocks.{k}, out{k} = out_convs.{k}.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.csp_darknet import ConvModule, CSPLayer


class YOLOXPAFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 320,
                 num_csp_blocks: int = 4, quant=False):
        super().__init__()
        ins = list(in_channels)
        self.n = n = len(ins)
        for idx in range(n - 1, 0, -1):
            k = n - 1 - idx
            # reduce{k} takes the deepest level (k = 0) or the previous CSP's output
            setattr(self, f"reduce{k}", ConvModule(ins[idx], ins[idx - 1], 1, quant=quant))
            setattr(self, f"td_csp{k}", CSPLayer(2 * ins[idx - 1], ins[idx - 1], num_csp_blocks,
                                                 add_identity=False, quant=quant))
        for k in range(n - 1):
            setattr(self, f"down{k}", ConvModule(ins[k], ins[k], 3, 2, quant=quant))
            setattr(self, f"bu_csp{k}", CSPLayer(2 * ins[k], ins[k + 1], num_csp_blocks,
                                                 add_identity=False, quant=quant))
        for i, c in enumerate(ins):
            setattr(self, f"out{i}", ConvModule(c, out_channels, 1, quant=quant))

    def forward(self, inputs):
        n = self.n
        inner = [inputs[-1]]
        for idx in range(n - 1, 0, -1):
            k = n - 1 - idx
            feat_low = inputs[idx - 1]
            feat_high = getattr(self, f"reduce{k}")(inner[0])
            inner[0] = feat_high
            up = F.interpolate(feat_high, scale_factor=2, mode="nearest")
            up = up[:, :, : feat_low.shape[2], : feat_low.shape[3]]
            inner.insert(0, getattr(self, f"td_csp{k}")(torch.cat([up, feat_low], dim=1)))
        outs = [inner[0]]
        for k in range(n - 1):
            down = getattr(self, f"down{k}")(outs[k])
            outs.append(getattr(self, f"bu_csp{k}")(torch.cat([down, inner[k + 1]], dim=1)))
        return [getattr(self, f"out{i}")(o) for i, o in enumerate(outs)]
