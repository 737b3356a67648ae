"""Shared building-block layers (fp paths of `bevformer_tensorrt_tpu/models/layers.py`).

Parameters are stored in float32 and cast to the input's dtype at use, as
the JAX `QDense`/`QConv` cast their kernels to the compute dtype, so one
module runs the float32 and the bfloat16 deploy paths.  The TPU's q-minor
orientations of `QDense` are a layout trick and do not carry over: the math
is `x @ W + b`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class QDense(nn.Linear):
    """Dense layer computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class QConv(nn.Conv2d):
    """NCHW convolution computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics returning the input's dtype
    (the `.astype(dt)` after every flax LayerNorm in the encoder/decoder)."""

    def __init__(self, dims: int, eps: float = 1e-5):
        super().__init__(dims, eps=eps)

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


class FrozenBN(nn.Module):
    """BatchNorm in eval mode: (x - mean) / sqrt(var + eps) * weight + bias
    (`bevformer_tensorrt_tpu/models/backbones/resnet.py:31-47`)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        shift = self.bias - self.mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class FFN(nn.Module):
    """fc1 -> relu -> fc2 with residual add."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.fc1 = QDense(embed_dims, feedforward_channels)
        self.fc2 = QDense(feedforward_channels, embed_dims)

    def forward(self, x, identity=None):
        out = self.fc2(F.relu(self.fc1(x)))
        return (x if identity is None else identity) + out


class LearnedPositionalEncoding(nn.Module):
    """Row/col learned embeddings -> [bs, H, W, 2*num_feats]."""

    def __init__(self, num_feats: int, row_num_embed: int, col_num_embed: int):
        super().__init__()
        self.row_embed = nn.Parameter(torch.zeros(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.zeros(col_num_embed, num_feats))

    def forward(self, bs: int):
        H, W, F_ = self.row_embed.shape[0], self.col_embed.shape[0], self.row_embed.shape[1]
        x = self.col_embed[None, :, :].expand(H, W, F_)
        y = self.row_embed[:, None, :].expand(H, W, F_)
        pos = torch.cat([x, y], dim=-1)
        return pos[None].expand(bs, H, W, 2 * F_)


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)
