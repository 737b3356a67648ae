"""CenterNet's deconv neck (CTResNetNeck), NCHW (port of
`bevformer_tensorrt_tpu/models/necks/ct_resnet_neck.py`).

mmdet's CTResNetNeck as the reference configures it
(configs/centernet/centernet_resnet18_dcnv2_140e_coco.py): three stages of
256 / 128 / 64 channels, each a DCNv2 (or, without `use_dcn`, a 3x3 conv)
with BN and ReLU, then a 4x4 transposed conv of stride 2 with BN and ReLU.

The transposed conv is torch's own (`padding=1`, as mmdet's), so the
upstream [in, out, 4, 4] weight loads as it is; flax's
`ConvTranspose(4x4, stride 2, "SAME")` correlates where torch convolves,
which is why the JAX importer flips the kernel and `weights.params_from_jax`
flips it back.  The flax layer has float32 parameters and no `dtype`, so it
computes in float32 whatever its input (flax promotes a bfloat16 input to
its kernel's float32): under `dtype="bfloat16"` the JAX network runs
float32 from the first transposed conv on, and so does the port.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.resnet import DeformConv2d
from ..layers import FrozenBN, QConv


class Deconv(nn.ConvTranspose2d):
    """4x4 transposed conv of stride 2, no bias, computed in float32.  On
    the card cuDNN runs it as a convolution's backward-data pass, some of
    whose algorithms accumulate with atomics: the call asks for a
    deterministic one, so that the same batch gives the same detections
    (the evaluator's pipelined loop against its serial loop)."""

    cudnn_deterministic = True  # an exported program sets the flag around its calls

    def __init__(self, channels: int):
        super().__init__(channels, channels, 4, stride=2, padding=1, bias=False)

    def forward(self, x):
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         benchmark_limit=cudnn.benchmark_limit, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            return F.conv_transpose2d(x.float(), self.weight, stride=2, padding=1)


class CTResNetNeck(nn.Module):
    def __init__(self, in_channels: int = 512, num_deconv_filters: Sequence[int] = (256, 128, 64),
                 use_dcn: bool = True, quant=False):
        super().__init__()
        self.filters = tuple(num_deconv_filters)
        self.use_dcn = use_dcn
        cin = in_channels
        for i, ch in enumerate(self.filters):
            if use_dcn:
                setattr(self, f"dcn{i}", DeformConv2d(cin, ch, 1, quant=quant))
            else:
                setattr(self, f"conv{i}", QConv(cin, ch, 3, 1, 1, bias=False, quant=quant))
            setattr(self, f"dcn_bn{i}", FrozenBN(ch))
            setattr(self, f"deconv{i}", Deconv(ch))
            setattr(self, f"deconv_bn{i}", FrozenBN(ch))
            cin = ch

    def forward(self, x):
        """x: [N, C, H, W], the deepest backbone feature -> upsampled x8."""
        for i in range(len(self.filters)):
            x = getattr(self, f"dcn{i}" if self.use_dcn else f"conv{i}")(x)
            x = F.relu(getattr(self, f"dcn_bn{i}")(x))
            x = F.relu(getattr(self, f"deconv_bn{i}")(getattr(self, f"deconv{i}")(x)))
        return x
