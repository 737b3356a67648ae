"""Weights of the port: conversion from the JAX package's flax variables
(the trees of BEVFormer, BEVDet, YOLOX and CenterNet), and a seeded
initialisation.

The port names every submodule as the flax module of the same role, so a
flax path `a/b/kernel` becomes the state_dict key `a.b.weight`:

  Dense kernel [in, out]   -> weight [out, in]
  Conv kernel HWIO         -> weight OIHW (DeformConv2d's own kernel too)
  ConvTranspose kernel HWIO of a `deconv*` module -> weight [in, out, kh, kw],
                              spatially flipped (flax correlates where torch's
                              transposed conv convolves)
  LayerNorm / FrozenBN scale -> weight;  bias -> bias
  FrozenBN batch_stats mean/var -> buffers mean/var
  embedding tables (bev/query embeddings, cams/level embeds,
  row/col positional embeds) -> copied as they are

and, from the "quant" collection of a calibrated model:

  <site>/scale (qdq_in, qdq_residual, qdq_q/k/v) -> the site's scale buffer
  <layer>/wq int8 [in, out] or HWIO -> wq [out, in] or OIHW, still int8
  <layer>/wscale [out]              -> wscale
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .models.backbones.resnet import DeformConv2d
from .models.heads.centerpoint_head import HEATMAP_PRIOR
from .models.layers import FrozenBN, LearnedPositionalEncoding, QConv, QDense

TABLES = ("bev_embedding", "query_embedding", "cams_embeds", "level_embeds",
          "row_embed", "col_embed")


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats", "quant"} tree (nested dicts of arrays)
    -> the port's state_dict.  Raises on any collection or leaf it does not
    consume; load the result with `load_state_dict(strict=True)`."""
    unknown = set(variables) - {"params", "batch_stats", "quant"}
    if unknown:
        raise KeyError(f"params_from_jax: unexpected collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables.get("params", {})):
        *mod, leaf = path
        if leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4 and mod and mod[-1].startswith("deconv"):
            name, arr = "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and arr.ndim == 1:
            name = "weight"
        elif leaf == "bias" and arr.ndim == 1:
            name = "bias"
        elif leaf in TABLES:
            name = leaf
        else:
            raise KeyError(f"params_from_jax: unconsumed leaf params/{'/'.join(path)} {arr.shape}")
        sd[".".join((*mod, name))] = torch.tensor(np.ascontiguousarray(arr, np.float32))
    for path, arr in _walk(variables.get("batch_stats", {})):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"params_from_jax: unconsumed leaf batch_stats/{'/'.join(path)}")
        sd[".".join(path)] = torch.tensor(np.asarray(arr, np.float32))
    for path, arr in _walk(variables.get("quant", {})):
        leaf = path[-1]
        if leaf == "scale" and arr.ndim == 0 and len(path) > 1 and path[-2].startswith("qdq_"):
            value = torch.tensor(np.asarray(arr, np.float32))
        elif leaf == "wq" and arr.dtype == np.int8 and arr.ndim in (2, 4):
            axes = (1, 0) if arr.ndim == 2 else (3, 2, 0, 1)
            value = torch.tensor(np.ascontiguousarray(arr.transpose(axes)))
        elif leaf == "wscale" and arr.ndim == 1:
            value = torch.tensor(np.asarray(arr, np.float32))
        else:
            raise KeyError(f"params_from_jax: unconsumed leaf quant/{'/'.join(path)} "
                           f"{arr.dtype} {arr.shape}")
        sd[".".join(path)] = value
    return sd


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation, the JAX package's initialisers in kind:
    LeCun-normal dense and conv kernels, zero biases (the classification
    output's prior -4.595, the heatmap prior -2.19 of BEVDet and CenterNet),
    LeCun-normal transposed-conv kernels (fan-in: input channels x taps),
    unit norms, unit-normal embedding tables and
    uniform [0, 1) positional tables.  Draws on the CPU from `generator`,
    then copies into the model's parameters, so a seed gives the same
    weights on every device."""

    def fill(p, sample):
        p.copy_(sample(tuple(p.shape)).to(p.device))

    def normal(std):
        return lambda s: torch.randn(s, generator=generator) * std

    for name, m in model.named_modules():
        if isinstance(m, (QDense, QConv, DeformConv2d)):
            fan_in = m.weight[0].numel()
            fill(m.weight, normal(1.0 / math.sqrt(fan_in)))
            if getattr(m, "bias", None) is not None:
                cls_out = name.split(".")[-1] == "out" and ".cls_branch" in f".{name}"
                heatmap = name.endswith(("pts_bbox_head.heatmap.conv2", "bbox_head.heatmap_out"))
                m.bias.fill_(-4.595 if cls_out else HEATMAP_PRIOR if heatmap else 0.0)
        elif isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            fill(m.weight, normal(1.0 / math.sqrt(fan_in)))
        elif isinstance(m, (nn.LayerNorm, FrozenBN)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, FrozenBN):
                m.mean.zero_()
                m.var.fill_(1.0)
        elif isinstance(m, LearnedPositionalEncoding):
            fill(m.row_embed, lambda s: torch.rand(s, generator=generator))
            fill(m.col_embed, lambda s: torch.rand(s, generator=generator))
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("bev_embedding", "query_embedding", "cams_embeds",
                                      "level_embeds"):
            fill(p, normal(1.0))
    return model
