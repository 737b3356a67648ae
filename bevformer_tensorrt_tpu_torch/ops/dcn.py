"""Modulated deformable convolution, DCNv2 (port of `bevformer_tensorrt_tpu/ops/dcn.py`).

For each output pixel s and kernel tap t the op samples the input at
`grid(s) + dilation * (i, j)_t + offset[t, s]` bilinearly (zero outside the
map), scales the sample by `mask[t, s]` (already sigmoided) and contracts
taps and channels with the weight.

`modulated_deform_conv2d` is the public function.  For CPU tensors it runs
`modulated_deform_conv2d_plain`.  For CUDA tensors the deformable im2col is
the kernel of `csrc/dcn.cu` (or the call raises); the product with the
weight that follows is one `torch.matmul` and the bias a tensor add, as the
JAX package leaves both to XLA outside its Pallas kernel.

`quant="int8"` samples from an int8 copy of the feature map (the JAX
package's `packed="int8"` gather table): `quantize_dcn_table` gives the map
one dynamic scale per (image, group of 64 or 32 consecutive channels), the
im2col gathers the int8 values (`deform_im2col_int8`, the second entry of
`csrc/dcn.cu`) and the scale multiplies the columns, which is exact because
a column is linear in the table.  The table is taken only where the JAX op
takes it: `groups == 1`, `deform_groups == 1` and `Cin % 32 == 0`
(`int8_table_eligible`); elsewhere `quant` is ignored and the op is the
floating-point one.  That is the op's contract in both packages, not a
fallback.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

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
    c_axis = 3 if layout == "NHWC" else 1
    N, Cin = x.shape[0], x.shape[c_axis]
    if Cin % ch_group:
        raise ValueError(f"dcn: ch_group {ch_group} does not divide Cin {Cin}")
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2) if layout == "NHWC" else (2, 3))  # [N, Cin]
    scale = amax.reshape(N, Cin // ch_group, ch_group).amax(-1).clamp_min(1e-12) / 127.0
    q = torch.round(xf / _per_channel(scale, Cin, layout)).clamp(-127, 127).to(torch.int8)
    return q, scale


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
                                  quant=False):
    """Plain PyTorch version (follows `_dcn_xla`): a loop over the kh*kw
    taps, each one bilinear gather and one [Cout, Cin] product, float32
    positions, weights and accumulation.  Any `groups` and `deform_groups`.
    With `quant="int8"` on an eligible shape the map is quantized and
    dequantized first (the int8 table), then sampled the same way.
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


def col_product(col, weight, bias, Ho: int, Wo: int, layout: str):
    """The product that follows the im2col: col [N, kh*kw*Cin, S] (row
    t*Cin + c) times weight [Cout, Cin, kh, kw], plus bias, in
    col.dtype (a float32 product for float32, a bfloat16 product with float32
    accumulation for bfloat16).  Returns [N, Cout, Ho, Wo], or
    [N, Ho, Wo, Cout] for layout "NHWC", which the product emits directly."""
    N, Cout = col.shape[0], weight.shape[0]
    w2 = weight.to(col.dtype).permute(0, 2, 3, 1).reshape(Cout, -1)  # [Cout, kh*kw*Cin]
    if layout == "NHWC":
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
        modulated_deform_conv2d.launches += 1
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
    return _launch_im2col(x, None, offset, mask, kernel_size, stride, padding, dilation,
                          deform_groups, layout)


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


def _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups, dg, layout,
              int8_table):
    N, Cin, H, W, Cout, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, dg, layout)
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("dcn kernel: weight and bias must be on x's device")
    if groups != 1:
        raise NotImplementedError("dcn kernel: groups > 1 is not ported to the card "
                                  "(no model of the repo uses it)")
    # one column buffer per call, freed to the allocator when the call
    # returns: 26 DCN layers reuse one block
    if int8_table:
        if x.dtype not in _DTYPES or offset.dtype != x.dtype or mask.dtype != x.dtype:
            raise TypeError("dcn int8 kernel: x, offset and mask must have one dtype, float32 "
                            "or bfloat16")
        q, scale = quantize_dcn_table(x, dcn_ch_group(Cin), layout)
        col = deform_im2col_int8(q, scale, offset, mask, (kh, kw), stride, padding, dilation,
                                 dg, layout)
    else:
        col = deform_im2col(x, offset, mask, (kh, kw), stride, padding, dilation, dg, layout)
    return col_product(col, weight, bias, Ho, Wo, layout)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1, padding=1,
                            dilation=1, groups=1, deform_groups=1, layout="NCHW", quant=False):
    """DCNv2 forward.

    Args:
      x: [N, Cin, H, W] (or [N, H, W, Cin] with layout="NHWC").
      offset: [N, 2*dg*kh*kw, Ho, Wo], per tap (y, x) interleaved, mmcv
        layout: channel 2t = y-offset of tap t, 2t+1 = x-offset.  NHWC: the
        same interleave on the last axis, [N, Ho, Wo, 2*dg*kh*kw].
      mask: [N, dg*kh*kw, Ho, Wo] (NHWC: [N, Ho, Wo, dg*kh*kw]), sigmoid
        already applied.
      weight: [Cout, Cin // groups, kh, kw].  On the card only groups = 1
        is taken (no model of the repo uses more); CPU tensors take any.
      bias: [Cout] or None.
      quant: False, True or "int8", the JAX op's meaning: "int8" samples
        from the int8 table of x (`quantize_dcn_table`) where the shape is
        eligible (`int8_table_eligible`: groups 1, deform_groups 1,
        Cin % 32 == 0); on any other shape, and for False or True, the op is
        the floating-point one.
    Returns:
      [N, Cout, Ho, Wo] (NHWC: [N, Ho, Wo, Cout]) in x.dtype.
    """
    _check_quant(quant)
    if x.is_cuda:
        Cin = x.shape[3 if layout == "NHWC" else 1] if x.dim() == 4 else 0
        int8_table = quant == "int8" and int8_table_eligible(Cin, groups, deform_groups)
        return _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups,
                         deform_groups, layout, int8_table)
    if x.device.type != "cpu":
        raise ValueError(f"dcn: unsupported device {x.device}")
    return modulated_deform_conv2d_plain(x, offset, mask, weight, bias, stride, padding,
                                         dilation, groups, deform_groups, layout, quant)


modulated_deform_conv2d.launches = 0
