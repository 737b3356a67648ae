"""Grid sampling in 2D and 3D (port of `bevformer_tensorrt_tpu/ops/grid_sample.py`).

The reference's GridSampler2DTRT / 3DTRT plugins
(TensorRT/plugin/grid_sampler/gridSamplerKernel.cu, Python contract
det2trt/models/functions/grid_sampler.py): bilinear, nearest and bicubic
interpolation, zeros, border and reflection padding, either `align_corners`,
the semantics of `torch.nn.functional.grid_sample`, which the JAX package
re-derives in jnp and which computes the same function here.  No TPU
kernel stands behind it (the JAX package leaves it to XLA), so stock
`F.grid_sample` carries it.  Coordinates are float32 whatever the data's
dtype; a bfloat16 map is sampled in float32 and rounded once at the end
(the JAX package blends bfloat16 maps in bfloat16, so the two differ there
by bfloat16 rounding).

`grid_sampler` takes the grid channel-first, as the reference's function
does.  The reference multiplies its grids by 10 before the plugin, which
divides them back (det2trt/models/functions/grid_sampler.py:30, for
float16's precision near 10); `scale` is that factor, 1 by default (the JAX
package's API has no pre-scaling).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("bilinear", "nearest", "bicubic")
PADDINGS = ("zeros", "border", "reflection")


def _sample(inp, grid, mode, padding_mode, align_corners):
    if mode not in MODES or padding_mode not in PADDINGS:
        raise ValueError(f"mode {mode!r} / padding {padding_mode!r}: expected one of {MODES} / "
                         f"{PADDINGS}")
    out = F.grid_sample(inp.float(), grid.float(), mode=mode, padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(inp.dtype)


def grid_sample_2d(inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """inp [N, C, H, W], grid [N, Hout, Wout, 2] in [-1, 1] (x, y) ->
    [N, C, Hout, Wout]."""
    return _sample(inp, grid, mode, padding_mode, align_corners)


def grid_sample_3d(inp: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """inp [N, C, D, H, W], grid [N, Dout, Hout, Wout, 3] in [-1, 1]
    (x, y, z) -> [N, C, Dout, Hout, Wout]; bilinear (trilinear) or nearest."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode {mode!r}: 3D sampling is bilinear or nearest")
    return _sample(inp, grid, mode, padding_mode, align_corners)


def grid_sampler(inp: torch.Tensor, grid: torch.Tensor, interpolation_mode: str = "bilinear",
                 padding_mode: str = "zeros", align_corners: bool = False,
                 scale: float = 1.0) -> torch.Tensor:
    """The reference's channel-first form
    (det2trt/models/functions/grid_sampler.py:144): grid [N, 2, Hout, Wout]
    or [N, 3, Dout, Hout, Wout], its values `scale` times the [-1, 1]
    coordinates."""
    if grid.ndim not in (4, 5):
        raise ValueError(f"grid must be 4D or 5D, got {grid.ndim}D")
    grid = torch.movedim(grid, 1, -1)
    if scale != 1.0:
        grid = grid.float() / scale
    fn = grid_sample_2d if grid.ndim == 4 else grid_sample_3d
    return fn(inp, grid, interpolation_mode, padding_mode, align_corners)
