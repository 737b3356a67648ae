"""Attach calibration scales to a model and fold its int8 weights
(port of `bevformer_tensorrt_tpu/quant/fold.py`).

The int8 layers (`models/layers.py` QDense / QConv, quant="int8") derive the
per-output-channel weight scale from the float weight at every forward.
`fold_int8_weights` computes (wq int8, wscale float32) once into buffers of
every layer that has a calibrated activation scale, and with them `wmat`,
the int8 product's weight operand (`int8_weight_matrix`), a derived
buffer that no state_dict carries; the layers then use the folded pair.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_matmul import K_ALIGN
from .qdq import QDQ


def quantize_weight(weight: torch.Tensor):
    """Per-output-channel int8 weight of a dense [out, in] or conv OIHW
    weight: (wq int8 of the same shape, wscale [out] float32)."""
    w = weight.detach().float()
    wscale = w.abs().amax(dim=tuple(range(1, w.dim()))) / 127.0 + 1e-12
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.round(w / wscale.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return wq, wscale


def int8_weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """The int8 product's w operand for an int8 dense [out, in] or conv
    OIHW weight: [out, K] contiguous, a conv's taps outermost and channels
    innermost (OIHW permuted to [O, kh, kw, I], the column order of
    `models/layers.py::int8_im2col`), K padded with zeros to a multiple of
    K_ALIGN."""
    w2 = (wq.permute(0, 2, 3, 1) if wq.dim() == 4 else wq).reshape(wq.shape[0], -1)
    pad = (-w2.shape[1]) % K_ALIGN
    return (F.pad(w2, (0, pad)) if pad else w2).contiguous()


@torch.no_grad()
def fold_int8_weights(model: nn.Module) -> nn.Module:
    """Fill `wq` / `wscale` of every quantized layer whose `qdq_in` holds a
    scale.  Idempotent; layers without a scale are left untouched (they
    cannot run the int8 path anyway)."""
    for m in model.modules():
        qdq = getattr(m, "qdq_in", None)
        if isinstance(qdq, QDQ) and qdq.scale is not None and qdq.mode != "off" and m.mode:
            m.wq, m.wscale = quantize_weight(m.weight)
            m.wmat = int8_weight_matrix(m.wq)
    return model


@torch.no_grad()
def attach_quant_scales(model: nn.Module, scales: Mapping[str, float]) -> nn.Module:
    """Set the `scale` of every live QDQ site named in `scales` ('/'-joined
    site path -> scale) and re-fold the int8 weights from the model's
    current parameters, so weights folded from an earlier checkpoint never
    survive.  A name that is no QDQ site of the model raises; sites that the
    policy switched off are skipped."""
    sites = {"/".join(name.split(".")): m for name, m in model.named_modules()
             if isinstance(m, QDQ)}
    unknown = sorted(set(scales) - set(sites))
    if unknown:
        raise KeyError(f"attach_quant_scales: no such QDQ sites: {unknown[:5]}")
    for name, value in scales.items():
        site = sites[name]
        if site.mode != "off":
            site.scale = torch.tensor(float(value), dtype=torch.float32,
                                      device=site.amax.device)
    for m in model.modules():
        if getattr(m, "wq", None) is not None:
            m.wq = m.wscale = m.wmat = None
    return fold_int8_weights(model)
