"""Modulated deformable convolution, DCNv2 (port of `bevformer_tensorrt_tpu/ops/dcn.py`).

For each output pixel s and kernel tap t the op samples the input at
`grid(s) + dilation * (i, j)_t + offset[t, s]` bilinearly (zero outside the
map), scales the sample by `mask[t, s]` (already sigmoided) and contracts
taps and channels with the weight.

`modulated_deform_conv2d` is the public function.  For CPU tensors it runs
`modulated_deform_conv2d_plain`.  For CUDA tensors it launches a kernel or
raises, by activation dtype (a rule fixed ahead of any failure):
- bfloat16: the fused kernel of `csrc/dcn_fused.cu`.  It gathers the
  corners from a channels-last table of the map (`dcn_gather_table`, one
  transposing pass) into shared memory and multiplies them there with the
  weight matrix (`dcn_weight_matrix`, [Cout, K padded to 64], which
  `DeformConv2d` keeps) on the tensor cores, so no column matrix exists;
  its tile configuration comes from `dcn_config`.
- float32: the deformable im2col kernel of `csrc/dcn.cu` (`deform_im2col`),
  then `col_product`, one `torch.matmul`, as the JAX package leaves the
  product to XLA.  The fused kernel's FFMA product lost to this route at
  both of base's DCN shapes on an H100 (PERF.md, section 6), so float32
  keeps it.
Any `groups` and `deform_groups`, NCHW and NHWC, on both devices.

Every launch is differentiable through `plain_vjp.with_plain_vjp`, as the
JAX package's custom_vjp around its kernel (`ops/dcn.py:257-280`): the
im2col kernel's backward is the VJP of `deform_im2col_plain` (the product
after it is `torch.matmul`, which autograd covers), the fused kernel's the
VJP of `modulated_deform_conv2d_plain` in float32, from the floating-point
map also for the int8 table (straight-through).

`quant="int8"` samples from an int8 copy of the feature map (the JAX
package's `packed="int8"` gather table): one dynamic scale per (image, group
of 64 or 32 consecutive channels), `quantize_dcn_table`.  On the card that
is always the fused kernel (`modulated_deform_conv2d_int8`; the FFMA product
for float32 activations): `dcn_gather_table` writes the channels-last int8
codes in one pass from one reduction's scale, and the scale multiplies the
blend, which is exact because a sample is linear in the table.  The table
is taken only where the JAX op takes it: `groups == 1`, `deform_groups == 1`
and `Cin % 32 == 0` (`int8_table_eligible`); elsewhere `quant` is ignored
and the op is the floating-point one.  That is the op's contract in both
packages, not a fallback.  The product stays in the activation dtype (the
JAX TPU path multiplies the int8-table columns in bfloat16).

`deform_im2col_int8` (the int8 table's im2col kernel) and, for bfloat16,
`deform_im2col` are the route the op took before the fused kernel: no model
path calls them there; they stay as its yardstick.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda
from .plain_vjp import with_plain_vjp

LAYOUTS = ("NCHW", "NHWC")


def _geometry(x, offset, mask, weight, stride, padding, dilation, groups, dg, layout):
    """Checks the op's contract; returns (N, Cin, H, W, Cout, kh, kw, Ho, Wo)."""
    if layout not in LAYOUTS:
        raise ValueError(f"dcn: layout {layout!r} is not one of {LAYOUTS}")
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4 or weight.dim() != 4:
        raise ValueError("dcn: x, offset, mask and weight must be 4-D")
    if layout == "NHWC":
        N, H, W, Cin = x.shape
    else:
        N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    if Cin % groups or Cout % groups or Cin_g * groups != Cin or Cin % dg:
        raise ValueError(f"dcn: channels {Cin} -> {Cout} do not fit groups {groups}, "
                         f"deform_groups {dg} and weight {tuple(weight.shape)}")
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    rows = dg * kh * kw
    want = ((N, Ho, Wo, 2 * rows), (N, Ho, Wo, rows)) if layout == "NHWC" else (
        (N, 2 * rows, Ho, Wo), (N, rows, Ho, Wo))
    if (tuple(offset.shape), tuple(mask.shape)) != want:
        raise ValueError(f"dcn: offset {tuple(offset.shape)} and mask {tuple(mask.shape)} "
                         f"must be {want[0]} and {want[1]}")
    return N, Cin, H, W, Cout, kh, kw, Ho, Wo


def _to_nchw(x, offset, mask, layout):
    if layout == "NHWC":
        return tuple(t.permute(0, 3, 1, 2) for t in (x, offset, mask))
    return x, offset, mask


def _tap_samples(xf, off, msk, t, kw, base_y, base_x, dilation, H, W):
    """Tap t of every output pixel, sampled and modulated.  xf
    [N, dg, Cin/dg, H*W] float32; off [N, dg, T, 2, S]; msk [N, dg, T, S];
    base_y, base_x [S].  Returns [N, dg, Cin/dg, S] float32.  Positions and
    bilinear weights are float32 whatever the input's dtype; a corner outside
    the map contributes 0, so a sample at p <= -1 or p >= size is 0."""
    cpg = xf.shape[2]
    i, j = divmod(t, kw)
    py = base_y + float(i * dilation) + off[:, :, t, 0]  # [N, dg, S]
    px = base_x + float(j * dilation) + off[:, :, t, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy1, wx1 = py - y0, px - x0
    # clamped before the integer conversion: far-out samples stay outside
    # the map (every corner fails the bounds test) and nothing overflows
    iy0 = y0.clamp(-2.0, float(H)).long()
    ix0 = x0.clamp(-2.0, float(W)).long()

    def corner(iy, ix, w):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        g = torch.gather(xf, 3, idx[:, :, None, :].expand(-1, -1, cpg, -1))
        return g * (w * valid)[:, :, None, :]

    sampled = (corner(iy0, ix0, (1 - wy1) * (1 - wx1))
               + corner(iy0, ix0 + 1, (1 - wy1) * wx1)
               + corner(iy0 + 1, ix0, wy1 * (1 - wx1))
               + corner(iy0 + 1, ix0 + 1, wy1 * wx1))
    return sampled * msk[:, :, t, None, :]


def _check_quant(quant) -> None:
    if quant not in (False, True, "int8"):
        raise ValueError(f"dcn: quant {quant!r}: expected False, True or 'int8'")


def _plain_operands(x, offset, mask, kh, kw, Ho, Wo, stride, padding, dg):
    N, Cin, H, W = x.shape
    S, T = Ho * Wo, kh * kw
    xf = x.float().reshape(N, dg, Cin // dg, H * W)
    off = offset.float().reshape(N, dg, T, 2, S)
    msk = mask.float().reshape(N, dg, T, S)
    ys = torch.arange(Ho, dtype=torch.float32, device=x.device) * stride - padding
    xs = torch.arange(Wo, dtype=torch.float32, device=x.device) * stride - padding
    base_y = ys[:, None].expand(Ho, Wo).reshape(S)
    base_x = xs[None, :].expand(Ho, Wo).reshape(S)
    return xf, off, msk, base_y, base_x


def int8_table_eligible(Cin: int, groups: int, deform_groups: int) -> bool:
    """Where `quant="int8"` takes the int8 table (the JAX op's `eligible`)."""
    return groups == 1 and deform_groups == 1 and Cin % 32 == 0


def dcn_ch_group(Cin: int) -> int:
    """Channels that share one scale of the int8 table: 64, or 32 where 64
    does not divide Cin."""
    return 64 if Cin % 64 == 0 else 32


def quantize_dcn_table(x, ch_group: int, layout="NCHW"):
    """The int8 table of a feature map: (q, scale) with q int8 of x's shape
    and layout and scale [N, Cin / ch_group] float32, one per image and group
    of `ch_group` consecutive channels:
    scale = max(amax, 1e-12) / 127, q = clip(round(x / scale), -127, 127),
    round half to even, float32 math whatever x's dtype."""
    if layout not in LAYOUTS:
        raise ValueError(f"dcn: layout {layout!r} is not one of {LAYOUTS}")
    Cin = x.shape[3 if layout == "NHWC" else 1]
    if Cin % ch_group:
        raise ValueError(f"dcn: ch_group {ch_group} does not divide Cin {Cin}")
    scale = dcn_table_scale(x, ch_group, layout)
    q = torch.round(x.float() / _per_channel(scale, Cin, layout)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dcn_gather_table_plain(x, layout="NCHW", ch_group=None):
    """Plain version of `dcn_gather_table`."""
    if ch_group is None:
        t = x if layout == "NHWC" else x.permute(0, 2, 3, 1)
        return t.contiguous(), None
    q, scale = quantize_dcn_table(x, ch_group, layout)
    return (q if layout == "NHWC" else q.permute(0, 2, 3, 1)).contiguous(), scale


def dcn_gather_table(x, layout="NCHW", ch_group=None):
    """The table the fused kernel gathers its corners from: the map with
    its channels last, [N, H, W, Cin] contiguous, and None; or with
    `ch_group`, the int8 table of `quantize_dcn_table` with its channels last
    and its scale [N, Cin / ch_group] float32 (codes bit for bit the plain
    version's, for a finite map).  A corner is then one run of contiguous
    channels, which the kernel reads 16 bytes at a time.  For a CUDA map each
    channel's max |x| comes from one pass of `dcn_channel_amax`, the scale
    from it as `dcn_table_scale` makes it, and the table from the one-pass
    kernel `dcn_gather_table` (both of `csrc/dcn_fused.cu`; an NHWC float map
    is its own table: no launch); CPU maps run the plain version."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"dcn: unsupported device {x.device}")
        return dcn_gather_table_plain(x, layout, ch_group)
    if layout not in LAYOUTS:
        raise ValueError(f"dcn: layout {layout!r} is not one of {LAYOUTS}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"dcn table kernel: x must be a contiguous 4-D float32 or bfloat16 "
                         f"map, got {x.dtype} {tuple(x.shape)}")
    N, Cin, H, W = x.permute(0, 3, 1, 2).shape if layout == "NHWC" else x.shape
    if ch_group is None and layout == "NHWC":
        return x, None
    scale = None
    lib = _fused_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if ch_group is not None:
        if Cin % ch_group:
            raise ValueError(f"dcn: ch_group {ch_group} does not divide Cin {Cin}")
        if x.numel() == 0:  # as the plain version does
            return dcn_gather_table_plain(x, layout, ch_group)
        amax = torch.empty((N, Cin), dtype=torch.float32, device=x.device)
        err = lib.dcn_channel_amax(x.data_ptr(), amax.data_ptr(), N, Cin, H, W,
                                   int(layout == "NHWC"), _DTYPES[x.dtype], stream)
        _cuda.check(lib, err, "dcn channel amax kernel launch")
        scale = _scale_of_amax(amax, ch_group)
    table = torch.empty((N, H, W, Cin), dtype=x.dtype if scale is None else torch.int8,
                        device=x.device)
    if table.numel() == 0:
        return table, scale
    err = lib.dcn_gather_table(x.data_ptr(), None if scale is None else scale.data_ptr(),
                               table.data_ptr(), N, Cin, H, W, int(layout == "NHWC"),
                               ch_group or 1, _DTYPES[x.dtype], stream)
    _cuda.check(lib, err, "dcn table kernel launch")
    dcn_gather_table.launches += 1
    return table, scale


dcn_gather_table.launches = 0


def dcn_table_scale(x, ch_group: int, layout="NCHW"):
    """The int8 table's scale alone, [N, Cin / ch_group] float32:
    max(amax over the group's channels and the map, 1e-12) / 127."""
    N, Cin = x.shape[0], x.shape[3 if layout == "NHWC" else 1]
    # max |x| = max(max x, -min x), exact in x's dtype: one pass, no copy
    lo, hi = torch.aminmax(x.reshape(N, -1, Cin) if layout == "NHWC" else
                           x.reshape(N, Cin, -1), dim=1 if layout == "NHWC" else 2)
    return _scale_of_amax(torch.maximum(hi, -lo).float(), ch_group)


def _scale_of_amax(amax, ch_group: int):
    """The scale [N, Cin / ch_group] from each channel's max |x| [N, Cin]
    float32 (the card's table computes that max in one kernel, then this)."""
    N, Cin = amax.shape
    return (amax.reshape(N, Cin // ch_group, ch_group).amax(-1).clamp_min(1e-12)
            / amax.new_full((), 127.0))  # a 0-dim divisor: exact on CUDA too


def _per_channel(scale, Cin: int, layout: str):
    """scale [N, G] -> each channel's scale, broadcastable against the map."""
    s = scale.repeat_interleave(Cin // scale.shape[1], dim=1)
    return s[:, None, None, :] if layout == "NHWC" else s[:, :, None, None]


def dequantize_dcn_table(q, scale, layout="NCHW"):
    """q * scale of its channel group, float32."""
    return q.float() * _per_channel(scale, q.shape[3 if layout == "NHWC" else 1], layout)


def deform_im2col_plain(x, offset, mask, kernel_size: Tuple[int, int], stride=1, padding=1,
                        dilation=1, deform_groups=1, layout="NCHW"):
    """Plain PyTorch version of the deformable im2col: the column matrix
    [N, kh*kw*Cin, Ho*Wo] in x.dtype, row t*Cin + c = tap t of channel c."""
    kh, kw = kernel_size
    x, offset, mask = _to_nchw(x, offset, mask, layout)
    N, Cin, H, W = x.shape
    Ho, Wo = offset.shape[2:]
    xf, off, msk, base_y, base_x = _plain_operands(
        x, offset, mask, kh, kw, Ho, Wo, stride, padding, deform_groups)
    cols = [_tap_samples(xf, off, msk, t, kw, base_y, base_x, dilation, H, W)
            .reshape(N, Cin, Ho * Wo) for t in range(kh * kw)]
    return torch.cat(cols, dim=1).to(x.dtype)


def deform_im2col_int8_plain(q, scale, offset, mask, kernel_size: Tuple[int, int], stride=1,
                             padding=1, dilation=1, deform_groups=1, layout="NCHW"):
    """Plain PyTorch version of `deform_im2col_int8`: the floating-point
    plain im2col of the dequantized table, in float32, returned in the dtype
    of `offset`."""
    x = dequantize_dcn_table(q, scale, layout)
    return deform_im2col_plain(x, offset, mask, kernel_size, stride, padding, dilation,
                               deform_groups, layout).to(offset.dtype)


def modulated_deform_conv2d_plain(x, offset, mask, weight, bias=None, stride=1, padding=1,
                                  dilation=1, groups=1, deform_groups=1, layout="NCHW",
                                  quant=False, wmat=None):
    """Plain PyTorch version (follows `_dcn_xla`): a loop over the kh*kw
    taps, each one bilinear gather and one [Cout, Cin] product, float32
    positions, weights and accumulation.  Any `groups` and `deform_groups`.
    With `quant="int8"` on an eligible shape the map is quantized and
    dequantized first (the int8 table), then sampled the same way.  `wmat`
    is taken for the wrapper's signature and not read.
    Returns the output in x.dtype and in `layout`."""
    N, Cin, H, W, Cout, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, deform_groups, layout)
    _check_quant(quant)
    if quant == "int8" and int8_table_eligible(Cin, groups, deform_groups):
        table = dequantize_dcn_table(*quantize_dcn_table(x, dcn_ch_group(Cin), layout), layout)
        return modulated_deform_conv2d_plain(table, offset, mask, weight, bias, stride, padding,
                                             dilation, groups, deform_groups, layout).to(x.dtype)
    x, offset, mask = _to_nchw(x, offset, mask, layout)
    xf, off, msk, base_y, base_x = _plain_operands(
        x, offset, mask, kh, kw, Ho, Wo, stride, padding, deform_groups)
    S = Ho * Wo
    wf = weight.float()
    out = x.new_zeros((N, Cout, S), dtype=torch.float32)
    for t in range(kh * kw):
        sampled = _tap_samples(xf, off, msk, t, kw, base_y, base_x, dilation, H, W)
        sampled = sampled.reshape(N, groups, Cin // groups, S)
        wt = wf[:, :, t // kw, t % kw].reshape(groups, Cout // groups, Cin // groups)
        out = out + torch.einsum("goc,ngcs->ngos", wt, sampled).reshape(N, Cout, S)
    if bias is not None:
        out = out + bias.float()[None, :, None]
    out = out.reshape(N, Cout, Ho, Wo)
    if layout == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out.to(x.dtype)


def modulated_deform_conv2d_int8_plain(x, offset, mask, weight, bias=None, stride=1,
                                       padding=1, dilation=1, groups=1, deform_groups=1,
                                       layout="NCHW", wmat=None):
    """Plain version of `modulated_deform_conv2d_int8`: the plain op under
    quant="int8"."""
    return modulated_deform_conv2d_plain(x, offset, mask, weight, bias, stride, padding, dilation,
                                         groups, deform_groups, layout, quant="int8")


def col_product(col, weight, bias, Ho: int, Wo: int, layout: str, groups: int = 1):
    """The product that follows the im2col: col [N, kh*kw*Cin, S] (row
    t*Cin + c) times weight [Cout, Cin / groups, kh, kw], plus bias, in
    col.dtype (a float32 product for float32, a bfloat16 product with float32
    accumulation for bfloat16).  Returns [N, Cout, Ho, Wo], or
    [N, Ho, Wo, Cout] for layout "NHWC", which the product emits directly.
    With groups > 1 each group's rows are gathered first (a copy)."""
    N, Cout = col.shape[0], weight.shape[0]
    w2 = weight.to(col.dtype).permute(0, 2, 3, 1).reshape(Cout, -1)  # [Cout, kh*kw*Cin/groups]
    if groups > 1:
        taps = w2.shape[1] // weight.shape[1]
        cg = col.reshape(N, taps, groups, -1, col.shape[2]).transpose(1, 2)
        cg = cg.reshape(N, groups, -1, col.shape[2])  # [N, groups, kh*kw*Cin/groups, S]
        wg = w2.reshape(groups, Cout // groups, -1)
        if layout == "NHWC":
            out = torch.matmul(cg.transpose(2, 3), wg.transpose(1, 2))  # [N, groups, S, Cout/g]
            out = out.permute(0, 2, 1, 3).reshape(N, -1, Cout)
        else:
            out = torch.matmul(wg, cg).reshape(N, Cout, -1)
    elif layout == "NHWC":
        out = torch.matmul(col.transpose(1, 2), w2.t())  # [N, S, Cout]
    else:
        out = torch.matmul(w2, col)  # [N, Cout, S]
    if bias is not None:
        b = bias.to(out.dtype)
        out = out + (b if layout == "NHWC" else b[:, None])
    if layout == "NHWC":
        return out.reshape(N, Ho, Wo, Cout)
    return out.reshape(N, Cout, Ho, Wo)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dcn_lib():
    lib = _cuda.load("dcn")
    if lib.dcn_im2col.argtypes is None:
        lib.dcn_im2col.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                                   + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
        lib.dcn_im2col.restype = ctypes.c_int
        lib.dcn_im2col_int8.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                                        + [ctypes.c_longlong] * 10
                                        + [ctypes.c_int, ctypes.c_void_p])
        lib.dcn_im2col_int8.restype = ctypes.c_int
    return lib


def _launch_im2col(x, table_scale, offset, mask, kernel_size, stride, padding, dilation,
                   deform_groups, layout):
    """Checks and launch shared by the two entries of `csrc/dcn.cu`.  `x` is
    the map (of offset's dtype) when `table_scale` is None, else its int8
    table with `table_scale` [N, Cin / ch_group] float32."""
    kh, kw = kernel_size
    what = "dcn kernel" if table_scale is None else "dcn int8 kernel"
    if layout not in LAYOUTS:
        raise ValueError(f"dcn: layout {layout!r} is not one of {LAYOUTS}")
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if offset.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {offset.dtype} is not float32 or bfloat16")
    if mask.dtype != offset.dtype:
        raise TypeError(f"{what}: offset and mask must have one dtype")
    if table_scale is None and x.dtype != offset.dtype:
        raise TypeError(f"{what}: offset and mask must have x's dtype {x.dtype}")
    if table_scale is not None and x.dtype != torch.int8:
        raise TypeError(f"{what}: the table must be int8, got {x.dtype}")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if not (x.is_contiguous() and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError(f"{what}: x, offset and mask must be 4-D")
    xn, on, mn = _to_nchw(x, offset, mask, layout)  # views: only the strides change
    N, Cin, H, W = xn.shape
    Ho, Wo = on.shape[2:]
    S = Ho * Wo
    rows = deform_groups * kh * kw
    if (Cin % deform_groups or tuple(on.shape) != (N, 2 * rows, Ho, Wo)
            or tuple(mn.shape) != (N, rows, Ho, Wo)):
        raise ValueError(f"{what}: offset {tuple(offset.shape)} and mask {tuple(mask.shape)} do "
                         f"not fit x {tuple(x.shape)} with {deform_groups} deform groups")
    if N > 65535 or H * W >= 2 ** 31 or kh * kw * Cin * S >= 2 ** 31:
        raise ValueError(f"{what}: shape x {tuple(x.shape)} is beyond the kernel's index range")
    if table_scale is not None:
        G = table_scale.shape[1] if table_scale.dim() == 2 else 0
        if (table_scale.dtype != torch.float32 or G < 1 or Cin % G
                or tuple(table_scale.shape) != (N, G) or not table_scale.is_contiguous()
                or table_scale.device != x.device):
            raise ValueError(f"{what}: the scale must be float32 [N, Cin / ch_group] on x's "
                             f"device, got {table_scale.dtype} {tuple(table_scale.shape)}")
    col = torch.empty((N, kh * kw * Cin, S), dtype=offset.dtype, device=x.device)
    if col.numel() == 0:
        return col
    # the (Ho, Wo) plane of offset and mask is addressed by one pixel stride
    strides = (*xn.stride(), *on.stride()[:2], on.stride(3), *mn.stride()[:2], mn.stride(3))
    geometry = (N, Cin, H, W, Ho, Wo, kh, kw, stride, padding, dilation, deform_groups)
    lib = _dcn_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if table_scale is None:
        err = lib.dcn_im2col(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), col.data_ptr(),
            *geometry, *strides, _DTYPES[offset.dtype], stream)
        _cuda.check(lib, err, "dcn im2col kernel launch")
        deform_im2col.launches += 1
    else:
        err = lib.dcn_im2col_int8(
            x.data_ptr(), table_scale.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            col.data_ptr(), *geometry, Cin // table_scale.shape[1], *strides,
            _DTYPES[offset.dtype], stream)
        _cuda.check(lib, err, "dcn int8 im2col kernel launch")
        deform_im2col_int8.launches += 1
    return col


def deform_im2col(x, offset, mask, kernel_size: Tuple[int, int], stride=1, padding=1,
                  dilation=1, deform_groups=1, layout="NCHW"):
    """The deformable im2col on the card: launches the kernel of
    `csrc/dcn.cu` and returns the column matrix [N, kh*kw*Cin, Ho*Wo] in
    x.dtype.  x, offset and mask are contiguous CUDA tensors of one dtype
    (float32 or bfloat16) in `layout`; the kernel reads either layout through
    strides, so no input is copied."""
    static = (tuple(kernel_size), stride, padding, dilation, deform_groups, layout)
    return with_plain_vjp(lambda x, o, m: _launch_im2col(x, None, o, m, *static),
                          deform_im2col_plain, (x, offset, mask), static)


deform_im2col.launches = 0


def deform_im2col_int8(q, scale, offset, mask, kernel_size: Tuple[int, int], stride=1,
                       padding=1, dilation=1, deform_groups=1, layout="NCHW"):
    """The deformable im2col from an int8 table: (q, scale) as
    `quantize_dcn_table` returns them, offset and mask float32 or bfloat16.
    Returns `scale * mask * sum of the bilinear corners of q`, the column
    matrix [N, kh*kw*Cin, Ho*Wo], in offset's dtype.  CUDA tensors launch the
    `dcn_im2col_int8` entry of `csrc/dcn.cu` (or the call raises), CPU
    tensors run `deform_im2col_int8_plain`."""
    if q.is_cuda:
        return _launch_im2col(q, scale, offset, mask, kernel_size, stride, padding, dilation,
                              deform_groups, layout)
    if q.device.type != "cpu":
        raise ValueError(f"dcn: unsupported device {q.device}")
    return deform_im2col_int8_plain(q, scale, offset, mask, kernel_size, stride, padding,
                                    dilation, deform_groups, layout)


deform_im2col_int8.launches = 0


DCN_K_ALIGN = 64  # K of the kept weight matrix is padded to a multiple of this
SMEM_LIMIT = 232448  # dynamic shared memory one block may opt into on Hopper
# name: (dtype, tile rows BM, tile pixels BN, channels a K step); the order is
# the `config` index of `dcn_fused_forward`
DCN_CONFIGS = {
    "bf16_256x128": (torch.bfloat16, 256, 128, 64),  # wgmma, two warpgroups of 2 x 64 rows
    "bf16_128x128": (torch.bfloat16, 128, 128, 64),  # wgmma, two warpgroups of 64 rows
    "f32_128x128": (torch.float32, 128, 128, 32),    # FFMA, 8x8 outputs a thread
    "f32_128x64": (torch.float32, 128, 64, 32),      # FFMA, 8x4 outputs a thread
}
A_STAGES = 2  # weight tiles in flight (kAStages in the source)
# blocks an SM, the kernels' launch bounds (the card may hold fewer)
BLOCKS_PER_SM = {"bf16_256x128": 1, "bf16_128x128": 2, "f32_128x128": 2, "f32_128x64": 2}
TABLE_ENTRY = 32  # bytes of one (tap, pixel) of the kernel's corner table


def dcn_config(cout_g: int, dtype, groups: int = 1, pixels: int = 1, sms: int = 132) -> str:
    """The fused kernel's tile configuration for `groups` conv groups of
    `cout_g` output channels over `pixels` output pixels (of all images: the
    FFMA kernel's pixel tiles run across them), on a card of `sms` SMs.
    float32 (the FFMA kernel): 128 x 128 tiles, or 128 x 64 where the
    128-pixel tiles are fewer than the blocks the card holds at once (their
    stream-K schedule then needs the smaller tiles; on an H100 small's stage
    4 is faster so, and base's and small's stage 3 and base's stage 4 with
    the larger ones).  bfloat16:
    the 256-row tile where the group has more than 128 outputs (the taps are
    then sampled once per 256 outputs, not once per 128: faster at all four
    of base's and small's DCN shapes on an H100, even where its grid is 96
    blocks), else the 128-row one."""
    if dtype == torch.float32:
        tiles = groups * -(-cout_g // 128) * -(-pixels // 128)
        return "f32_128x128" if tiles >= BLOCKS_PER_SM["f32_128x128"] * sms else "f32_128x64"
    if dtype == torch.bfloat16:
        return "bf16_256x128" if cout_g > 128 else "bf16_128x128"
    raise TypeError(f"dcn kernel: dtype {dtype} is not float32 or bfloat16")


def dcn_smem_bytes(config: str, taps: int) -> int:
    """Dynamic shared memory of one block, as `Kernel::smem` in the source:
    alignment slack, the ring of weight tiles (BM rows of 128 bytes each),
    two sampled tiles of BN pixels of 128 bytes (the FFMA kernel: one, and
    the staging of the int8 corners), the corner table of the tile (`taps` x
    BN entries) and each pixel's image.  The bfloat16 epilogue stages the
    output tile in the weight and sampled tiles' bytes."""
    _, bm, bn, _ = DCN_CONFIGS[config]
    return 1024 + A_STAGES * bm * 128 + 2 * bn * 128 + taps * bn * TABLE_ENTRY + 4 * bn



def dcn_epilogue_bytes(config: str, pixel_major: bool) -> int:
    """Bytes the bfloat16 epilogue stages in the freed buffers: the BM x BN
    tile, rows padded by 8 (0 for the float32 tile, stored from registers)."""
    dtype, bm, bn, _ = DCN_CONFIGS[config]
    if dtype == torch.float32:
        return 0
    return 2 * (bm * (bn + 8) if pixel_major else bn * (bm + 8))


def dcn_weight_matrix(weight, dtype):
    """The fused kernel's weight operand for an OIHW weight [Cout, Cin / groups,
    kh, kw], in `dtype`, contiguous: row o holds its group's taps and channels
    in (tap, channel) order (the column order of the im2col, as
    `col_product`'s matrix), K zero-padded to a multiple of DCN_K_ALIGN.
    bfloat16 (the wgmma kernel reads K-major tiles): [Cout, K]; float32 (the
    FFMA kernel reads tiles with the outputs contiguous): its transpose
    [K, Cout], Cout zero-padded to a multiple of 4 (TMA's 16-byte rows)."""
    Cout = weight.shape[0]
    w2 = weight.to(dtype).permute(0, 2, 3, 1).reshape(Cout, -1)
    K = w2.shape[1]
    Kp = -(-K // DCN_K_ALIGN) * DCN_K_ALIGN
    if dtype == torch.float32:
        out = torch.zeros((Kp, -(-Cout // 4) * 4), dtype=dtype, device=weight.device)
        out[:K, :Cout] = w2.t()
        return out
    out = torch.zeros((Cout, Kp), dtype=dtype, device=weight.device)
    out[:, :K] = w2
    return out


def _fused_lib(name="dcn_fused"):
    lib = _cuda.load(name)
    if lib.dcn_fused_forward.argtypes is None:
        lib.dcn_fused_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 17
                                          + [ctypes.c_longlong] * 13
                                          + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                             ctypes.c_int] + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
        lib.dcn_fused_forward.restype = ctypes.c_int
        if hasattr(lib, "dcn_fused_blocks_per_sm"):
            lib.dcn_fused_blocks_per_sm.argtypes = [ctypes.c_int] * 3
            lib.dcn_fused_blocks_per_sm.restype = ctypes.c_int
        lib.dcn_gather_table.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.dcn_gather_table.restype = ctypes.c_int
        lib.dcn_channel_amax.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.dcn_channel_amax.restype = ctypes.c_int
    return lib


def _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups, dg, layout,
              int8_table, wmat=None):
    """The fused kernel on the card for the op's two uses of it, a bfloat16
    map and an int8 table: the gather table, then one launch.  A float32 map
    takes the im2col route (`_dcn_im2col_route`); the FFMA kernel on a
    float32 map is reached only through `fused_launcher`, by the bench and
    chip_smoke.py, which time it against that route."""
    if x.dtype == torch.float32 and not int8_table:
        raise ValueError("dcn kernel: a float32 map takes the im2col route")

    def launch(x, offset, mask, weight, bias):
        out, run = fused_launcher(x, offset, mask, weight, bias, stride, padding, dilation,
                                  groups, dg, layout, int8_table, wmat)
        run()
        return out

    return with_plain_vjp(launch, _plain_float32, (x, offset, mask, weight, bias),
                          (stride, padding, dilation, groups, dg, layout))


def _plain_float32(x, offset, mask, weight, bias, *static):
    """The floating-point plain op on float32 copies of its inputs: the
    fused kernel's gradient (the JAX backward's float32 VJP of `_dcn_xla`)."""
    return modulated_deform_conv2d_plain(x.float(), offset.float(), mask.float(),
                                         weight.float(), None if bias is None else bias.float(),
                                         *static)


def fused_launcher(x, offset, mask, weight, bias, stride, padding, dilation, groups, dg, layout,
                   int8_table, wmat=None):
    """Checks the operands of the fused kernel and makes its gather table;
    returns (out, launch): `launch(config=None, cut=0)` runs the kernel into
    `out` under `dcn_config`'s tile configuration, or another for the bench,
    and counts the launch.  `cut` is 0; `tools/kernel_bench.py --parts
    dcn_split` times the kernel without its corner loads (1) or without its
    product (2).  `wmat` is the kept weight matrix (made here when None)."""
    N, Cin, H, W, Cout, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, dg, layout)
    what = "dcn int8 kernel" if int8_table else "dcn kernel"
    if x.dtype not in _DTYPES or offset.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError(f"{what}: x, offset and mask must have one dtype, float32 or bfloat16")
    if (offset.device != x.device or mask.device != x.device or weight.device != x.device
            or (bias is not None and bias.device != x.device)):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if not (x.is_contiguous() and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    xn, on, mn = _to_nchw(x, offset, mask, layout)  # views: only the strides change
    S = Ho * Wo
    if x.numel() >= 2 ** 31 or N * S >= 2 ** 31:
        raise ValueError(f"{what}: shape x {tuple(x.shape)} is beyond the kernel's index range")
    if wmat is None:
        wmat = dcn_weight_matrix(weight, x.dtype)
    K = kh * kw * (Cin // groups)
    kmajor = x.dtype != torch.float32  # float32: the transposed matrix [Kp, Cout padded]
    kp = wmat.shape[1 if kmajor else 0] if wmat.dim() == 2 else 0
    rows_ok = (wmat.shape[0] == Cout if kmajor
               else wmat.shape[1] >= Cout and wmat.shape[1] % 4 == 0) if wmat.dim() == 2 else False
    if (wmat.dtype != x.dtype or not rows_ok or kp % DCN_K_ALIGN or kp < K
            or not wmat.is_contiguous() or wmat.device != x.device):
        want = (f"[{Cout}, K >= {K} padded to {DCN_K_ALIGN}]" if kmajor else
                f"[K >= {K} padded to {DCN_K_ALIGN}, {Cout} padded to 4]")
        raise ValueError(f"{what}: the weight matrix must be {want} in {x.dtype}, contiguous, "
                         f"on x's device")
    shape = (N, Ho, Wo, Cout) if layout == "NHWC" else (N, Cout, Ho, Wo)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, lambda config=None, cut=0: None
    ch_group = dcn_ch_group(Cin) if int8_table else None
    table, scale = dcn_gather_table(x, layout, ch_group)
    tn = table.permute(0, 3, 1, 2)  # channels last, seen as [N, C, H, W]
    b = None if bias is None else bias.float().contiguous()
    yn = out.permute(0, 3, 1, 2) if layout == "NHWC" else out
    # the (Ho, Wo) plane of offset, mask and out is addressed by one pixel stride
    strides = (*tn.stride(), *on.stride()[:2], on.stride(3), *mn.stride()[:2], mn.stride(3),
               *yn.stride()[:2], yn.stride(3))
    pe = 16 // x.element_size()  # channels of a 16-byte piece of the sampled tile
    vec_x = (Cin % pe == 0 and (Cin // groups) % pe == 0 and (Cin // dg) % pe == 0
             and table.data_ptr() % 16 == 0)
    if layout == "NHWC":  # 16-byte stores of consecutive channels of a group
        vec_out = Cout % pe == 0 and (Cout // groups) % pe == 0
    else:  # 16-byte stores of consecutive pixels of a channel
        vec_out = S % pe == 0
    vec_out = vec_out and out.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream

    sms = torch.cuda.get_device_properties(x.device).multi_processor_count

    def launch(config=None, cut=0):
        lib = _fused_lib("dcn_fused_split" if cut else "dcn_fused")
        config = config or dcn_config(Cout // groups, x.dtype, groups, N * S, sms)
        if DCN_CONFIGS[config][0] != x.dtype:
            raise ValueError(f"{what}: configuration {config} does not take {x.dtype}")
        if dcn_smem_bytes(config, kh * kw) > SMEM_LIMIT:
            raise ValueError(f"{what}: a {kh}x{kw} kernel needs more shared memory than a "
                             f"block has")
        ws, counts = _stream_k_workspace(config, groups, Cout // groups, N * S, sms, x.device)
        err = lib.dcn_fused_forward(
            table.data_ptr(), None if scale is None else scale.data_ptr(), offset.data_ptr(),
            mask.data_ptr(), wmat.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), N, Cin, H, W, Ho, Wo, kh, kw, stride, padding, dilation, dg, groups,
            Cout, kp, wmat.shape[1], ch_group or 1, *strides,
            None if ws is None else ws.data_ptr(), 0 if ws is None else ws.numel() * 4,
            None if counts is None else counts.data_ptr(), 0 if counts is None else counts.numel(),
            _DTYPES[x.dtype],
            list(DCN_CONFIGS).index(config), int(vec_x), int(vec_out), cut, stream)
        _cuda.check(lib, err, f"{what} launch")
        if int8_table:
            modulated_deform_conv2d_int8.launches += 1
        else:
            modulated_deform_conv2d.launches += 1

    return out, launch


_stream_k_counts: dict = {}  # device -> the kernels' arrival counts, zero between launches


def _stream_k_workspace(config, groups, cout_g, pixels, sms, device):
    """The fused kernel's stream-K workspace where its tiles outnumber the
    blocks the card holds at once (else (None, None)): two float32 shares of a
    tile for each block boundary, and the boundaries' arrival counts (zero,
    and left zero by the kernel; one launch at a time on a device)."""
    blocks = BLOCKS_PER_SM[config]
    _, bm, bn, _ = DCN_CONFIGS[config]
    slots = blocks * sms  # at most; the card may hold fewer
    if groups * -(-cout_g // bm) * -(-pixels // bn) <= sms:
        return None, None
    counts = _stream_k_counts.get(device)
    if counts is None or counts.numel() < slots + 1:
        counts = _stream_k_counts[device] = torch.zeros(slots + 1, dtype=torch.int32,
                                                        device=device)
    return torch.empty((slots + 1) * 2 * bm * bn, dtype=torch.float32, device=device), counts


def dcn_blocks_per_sm(config: str, int8_table: bool, taps: int = 9) -> int:
    """Blocks of the fused kernel's configuration that fit one SM at once
    (registers and shared memory), as the card reports it."""
    return _fused_lib().dcn_fused_blocks_per_sm(list(DCN_CONFIGS).index(config),
                                                int(int8_table), taps)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1, padding=1,
                            dilation=1, groups=1, deform_groups=1, layout="NCHW", quant=False,
                            wmat=None):
    """DCNv2 forward.

    Args:
      x: [N, Cin, H, W] (or [N, H, W, Cin] with layout="NHWC").
      offset: [N, 2*dg*kh*kw, Ho, Wo], per tap (y, x) interleaved, mmcv
        layout: channel 2t = y-offset of tap t, 2t+1 = x-offset.  NHWC: the
        same interleave on the last axis, [N, Ho, Wo, 2*dg*kh*kw].
      mask: [N, dg*kh*kw, Ho, Wo] (NHWC: [N, Ho, Wo, dg*kh*kw]), sigmoid
        already applied.
      weight: [Cout, Cin // groups, kh, kw].
      bias: [Cout] or None.
      quant: False, True or "int8", the JAX op's meaning: "int8" samples
        from the int8 table of x (`modulated_deform_conv2d_int8`) where the
        shape is eligible (`int8_table_eligible`: groups 1, deform_groups 1,
        Cin % 32 == 0); on any other shape, and for False or True, the op is
        the floating-point one.
      wmat: the weight as `dcn_weight_matrix(weight, x.dtype)`, kept by the
        caller (the card makes it per call where it is None; the plain
        version does not read it).
    Returns:
      [N, Cout, Ho, Wo] (NHWC: [N, Ho, Wo, Cout]) in x.dtype.
    """
    _check_quant(quant)
    Cin = x.shape[3 if layout == "NHWC" else 1] if x.dim() == 4 else 0
    if quant == "int8" and int8_table_eligible(Cin, groups, deform_groups):
        return modulated_deform_conv2d_int8(x, offset, mask, weight, bias, stride, padding,
                                            dilation, groups, deform_groups, layout, wmat=wmat)
    if x.is_cuda and x.dtype == torch.float32:
        return _dcn_im2col_route(x, offset, mask, weight, bias, stride, padding, dilation,
                                 groups, deform_groups, layout)
    if x.is_cuda:
        return _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups,
                         deform_groups, layout, False, wmat)
    if x.device.type != "cpu":
        raise ValueError(f"dcn: unsupported device {x.device}")
    return modulated_deform_conv2d_plain(x, offset, mask, weight, bias, stride, padding,
                                         dilation, groups, deform_groups, layout)


modulated_deform_conv2d.launches = 0


def _dcn_im2col_route(x, offset, mask, weight, bias, stride, padding, dilation, groups, dg,
                      layout):
    """The float32 map on the card: the deformable im2col kernel, then
    `col_product`.  The fused kernel's FFMA product lost to this route at
    both of base's DCN shapes on an H100 (PERF.md, section 6), so float32
    keeps it."""
    _, _, _, _, _, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, dg, layout)
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("dcn kernel: weight and bias must be on x's device")
    col = deform_im2col(x, offset, mask, (kh, kw), stride, padding, dilation, dg, layout)
    return col_product(col, weight, bias, Ho, Wo, layout, groups)


def modulated_deform_conv2d_int8(x, offset, mask, weight, bias=None, stride=1, padding=1,
                                 dilation=1, groups=1, deform_groups=1, layout="NCHW",
                                 wmat=None):
    """`modulated_deform_conv2d` from the int8 table of x, on a shape that
    `int8_table_eligible` takes (else it raises): the same arguments, x
    float32 or bfloat16.  CUDA tensors launch the fused kernel with the
    codes computed at the gather; CPU tensors run the plain op under
    quant="int8".  The kernel's gradient is the float32 plain op's on the
    floating-point map (straight-through)."""
    Cin = x.shape[3 if layout == "NHWC" else 1] if x.dim() == 4 else 0
    if not int8_table_eligible(Cin, groups, deform_groups):
        raise ValueError(f"dcn: the int8 table takes groups 1, deform_groups 1 and Cin % 32 "
                         f"== 0, got groups {groups}, deform_groups {deform_groups}, Cin {Cin}")
    if x.is_cuda:
        return _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups,
                         deform_groups, layout, True, wmat)
    if x.device.type != "cpu":
        raise ValueError(f"dcn: unsupported device {x.device}")
    return modulated_deform_conv2d_int8_plain(x, offset, mask, weight, bias, stride, padding,
                                              dilation, groups, deform_groups, layout)


modulated_deform_conv2d_int8.launches = 0
