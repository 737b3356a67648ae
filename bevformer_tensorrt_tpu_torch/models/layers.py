"""Shared building-block layers with optional quantization sites (port of
`bevformer_tensorrt_tpu/models/layers.py`).

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

from ..ops import int8_matmul as int8_ops
from ..quant.fake_quant import fake_quant, per_channel_scale
from ..quant.fold import quantize_weight
from ..quant.policy import effective_quant
from ..quant.qdq import QDQ, OptionalBuffers


def _check_int8_scale(mod, s_in) -> None:
    """quant="int8" with no calibrated activation scale would silently run
    floating point; fail instead, unless this is a calibration pass, where
    scales do not exist yet."""
    if mod.mode == "int8" and s_in is None and not mod.qdq_in.calibrating:
        raise ValueError(
            f"{mod.__class__.__name__} '{'/'.join(mod.path)}': quant='int8' requires "
            "calibrated activation scales (the 'quant' collection); run the "
            "calibration tool first, or use quant=True for fake-quant.")


class _QuantSite(OptionalBuffers):
    """What QDense and QConv share: the `quant` convention, the activation
    QDQ site `qdq_in`, and the folded int8 weight.

    quant:
      False  - plain floating-point layer.
      True   - QDQ fake-quant: `qdq_in` on the input, per-output-channel
               fake-quant of the weight (scale from the weight itself).
      "int8" - real int8 execution: the input quantized with the calibrated
               per-tensor scale, the weight int8 per output channel (the
               folded `wq` / `wscale` buffers when present), the product in
               `ops.int8_matmul` with int32 sums and a fused dequantization,
               the bias added in float32.  Raises without a scale outside
               calibration.
    `mode` is `quant` resolved under the model's policy
    (`quant.policy.set_quant_exclude`); an excluded layer runs plain."""

    OPTIONAL = ("wq", "wscale")

    def _init_quant(self, quant) -> None:
        if quant not in (False, True, "int8"):
            raise ValueError(f"quant {quant!r}: expected False, True or 'int8'")
        self.quant = quant
        self.mode = quant
        self.path: tuple = ()
        if quant:
            self.qdq_in = QDQ()
        self.register_buffer("wq", None)
        self.register_buffer("wscale", None)

    def resolve_quant(self, path, exclude) -> None:
        self.path = tuple(path)
        self.mode = effective_quant(self.quant, path, exclude)

    def _int8_weight(self):
        if self.wq is not None:
            return self.wq, self.wscale
        return quantize_weight(self.weight)

    def _fake_quant_weight(self):
        return fake_quant(self.weight, per_channel_scale(self.weight, axis=0))


def _quantize_input(x, s_in):
    return torch.round(x.float() / s_in).clamp(-127, 127).to(torch.int8)


class QDense(nn.Linear, _QuantSite):
    """Dense layer computing in the input's dtype, with quantization sites."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, quant=False):
        super().__init__(in_features, out_features, bias=bias)
        self._init_quant(quant)

    def forward(self, x):
        weight = self.weight
        if self.mode:
            x_scaled, s_in = self.qdq_in(x)
            _check_int8_scale(self, s_in)
            if self.mode == "int8" and s_in is not None:
                wq, wscale = self._int8_weight()
                y = int8_ops.int8_matmul(
                    _quantize_input(x, s_in).reshape(-1, self.in_features), wq, s_in, wscale)
                if self.bias is not None:
                    y = y + self.bias
                return y.reshape(*x.shape[:-1], self.out_features).to(x.dtype)
            x = x_scaled
            weight = self._fake_quant_weight()
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, weight.to(x.dtype), b)


def int8_im2col(xq, kernel_size, stride, padding, k_align: int = 1):
    """Columns of an int8 NCHW map for a convolution as a matrix product:
    [N * Ho * Wo, kh * kw * C (+ zero padding up to a multiple of k_align)],
    taps outermost and channels innermost, so the matching weight is OIHW
    permuted to [O, kh, kw, I].  Returns (columns, Ho, Wo)."""
    N, C, H, W = xq.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    nhwc = xq.permute(0, 2, 3, 1)
    if (kh, kw, ph, pw) == (1, 1, 0, 0) and C % k_align == 0:
        return nhwc[:, ::sh, ::sw].reshape(N * Ho * Wo, C), Ho, Wo
    padded = xq.new_zeros((N, H + 2 * ph, W + 2 * pw, C))
    padded[:, ph:ph + H, pw:pw + W] = nhwc
    K = kh * kw * C
    Kp = -(-K // k_align) * k_align
    col = xq.new_empty((N, Ho, Wo, Kp))
    if Kp > K:
        col[..., K:] = 0
    for ky in range(kh):
        for kx in range(kw):
            t = (ky * kw + kx) * C
            col[..., t:t + C] = padded[:, ky:ky + sh * (Ho - 1) + 1:sh,
                                       kx:kx + sw * (Wo - 1) + 1:sw]
    return col.reshape(N * Ho * Wo, Kp), Ho, Wo


class QConv(nn.Conv2d, _QuantSite):
    """NCHW convolution computing in the input's dtype, with quantization
    sites.  Under "int8" the convolution is lowered to the int8 product: a
    1x1 is a reshape of the channels-last map, a k x k an explicit im2col of
    the int8 values (`int8_im2col`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0,
                 bias: bool = True, quant=False):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self._init_quant(quant)

    def _int8_forward(self, x, s_in):
        wq, wscale = self._int8_weight()
        col, Ho, Wo = int8_im2col(_quantize_input(x, s_in), self.kernel_size, self.stride,
                                  self.padding, int8_ops.K_ALIGN)
        w2 = wq.permute(0, 2, 3, 1).reshape(self.out_channels, -1)
        if col.shape[1] > w2.shape[1]:
            w2 = F.pad(w2, (0, col.shape[1] - w2.shape[1]))
        y = int8_ops.int8_matmul(col, w2.contiguous(), s_in, wscale)
        if self.bias is not None:
            y = y + self.bias
        # channels-last memory under an NCHW shape: no relayout
        return y.reshape(x.shape[0], Ho, Wo, self.out_channels).permute(0, 3, 1, 2).to(x.dtype)

    def forward(self, x):
        weight = self.weight
        if self.mode:
            x_scaled, s_in = self.qdq_in(x)
            _check_int8_scale(self, s_in)
            if self.mode == "int8" and s_in is not None:
                return self._int8_forward(x, s_in)
            x = x_scaled
            weight = self._fake_quant_weight()
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, weight.to(x.dtype), b)


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

    def __init__(self, embed_dims: int, feedforward_channels: int, quant=False):
        super().__init__()
        self.fc1 = QDense(embed_dims, feedforward_channels, quant=quant)
        self.fc2 = QDense(feedforward_channels, embed_dims, quant=quant)

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
