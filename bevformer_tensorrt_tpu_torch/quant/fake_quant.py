"""Fake quantization (QDQ) primitives (port of `bevformer_tensorrt_tpu/quant/fake_quant.py`).

`fake_quant` is quantize -> dequantize in one op; its backward is the
straight-through estimator (gradient passes inside the clip range and is zero
outside).  `quantize` / `dequantize` are the real int8 conversions.  Rounding
is to nearest, halves to even, as `jnp.round`.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """float -> int8 with a per-tensor (or broadcastable) scale."""
    q = torch.round(x.float() / scale)
    return q.clamp(-128, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        ctx.save_for_backward(x, scale)
        q = torch.round(x.float() / scale).clamp(-128, 127)
        return (q * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        # straight-through inside the representable range, zero outside
        return g * (x.float().abs() <= 127.0 * scale).to(g.dtype), None


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize-dequantize with the straight-through backward."""
    return _FakeQuant.apply(x, scale)


def per_channel_scale(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-output-channel weight scale, kept broadcastable against `w`."""
    axis = axis % w.dim()
    dims = [i for i in range(w.dim()) if i != axis]
    amax = w.float().abs().amax(dim=dims, keepdim=True)
    return amax.clamp_min(1e-12) / amax.new_full((), 127.0)  # exact on CUDA too
