"""Rotate a [C, H, W] feature map about a center point
(port of `bevformer_tensorrt_tpu/ops/rotate.py`).

Inverse-mapping affine grid and a nearest resample with zeros padding,
align_corners=False (torchvision rotate semantics).  The JAX package
computes this in XLA, not in a kernel, so `F.grid_sample` carries it; its
nearest mode rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rotate(img, angle, center, interpolation: str = "nearest"):
    """Rotate `img` [C, H, W] by `angle` degrees (a scalar tensor on the
    image's device) counter-clockwise about `center`, (x, y) in pixels as
    two numbers; zeros outside."""
    C, H, W = img.shape
    dev = img.device
    angle = angle.float().reshape(())
    cx = float(center[0]) - 0.5 * W
    cy = float(center[1]) - 0.5 * H
    a = -angle * (math.pi / 180.0)
    cos, sin = torch.cos(a), torch.sin(a)
    t02 = -cx * cos - cy * sin + cx
    t12 = cx * sin - cy * cos + cy

    d = 0.5
    xs = torch.linspace(-0.5 * W + d, 0.5 * W + d - 1.0, W, dtype=torch.float32, device=dev)
    ys = torch.linspace(-0.5 * H + d, 0.5 * H + d - 1.0, H, dtype=torch.float32, device=dev)
    base_x = xs[None, :].expand(H, W)
    base_y = ys[:, None].expand(H, W)

    gx = (base_x * cos + base_y * sin + t02) * (2.0 / W)
    gy = (base_x * -sin + base_y * cos + t12) * (2.0 / H)
    grid = torch.stack([gx, gy], dim=-1)[None]  # [1, H, W, 2]
    out = F.grid_sample(img[None].float(), grid, mode=interpolation,
                        padding_mode="zeros", align_corners=False)
    return out[0].to(img.dtype)
