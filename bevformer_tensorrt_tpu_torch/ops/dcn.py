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


def modulated_deform_conv2d_plain(x, offset, mask, weight, bias=None, stride=1, padding=1,
                                  dilation=1, groups=1, deform_groups=1, layout="NCHW"):
    """Plain PyTorch version (follows `_dcn_xla`): a loop over the kh*kw
    taps, each one bilinear gather and one [Cout, Cin] product, float32
    positions, weights and accumulation.  Any `groups` and `deform_groups`.
    Returns the output in x.dtype and in `layout`."""
    N, Cin, H, W, Cout, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, deform_groups, layout)
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
    return lib


def deform_im2col(x, offset, mask, kernel_size: Tuple[int, int], stride=1, padding=1,
                  dilation=1, deform_groups=1, layout="NCHW"):
    """The deformable im2col on the card: launches the kernel of
    `csrc/dcn.cu` and returns the column matrix [N, kh*kw*Cin, Ho*Wo] in
    x.dtype.  x, offset and mask are contiguous CUDA tensors of one dtype
    (float32 or bfloat16) in `layout`; the kernel reads either layout through
    strides, so no input is copied."""
    kh, kw = kernel_size
    if not x.is_cuda:
        raise ValueError("dcn kernel: x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dcn kernel: x dtype {x.dtype} is not float32 or bfloat16")
    if offset.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError("dcn kernel: offset and mask must have x's dtype")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError("dcn kernel: all inputs must be on one CUDA device")
    if not (x.is_contiguous() and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError("dcn kernel: inputs must be contiguous")
    xn, on, mn = _to_nchw(x, offset, mask, layout)  # views: only the strides change
    N, Cin, H, W = xn.shape
    Ho, Wo = on.shape[2:]
    S = Ho * Wo
    if N > 65535 or H * W >= 2 ** 31 or kh * kw * Cin * S >= 2 ** 31:
        raise ValueError(f"dcn kernel: shape x {tuple(x.shape)} is beyond the kernel's index range")
    col = torch.empty((N, kh * kw * Cin, S), dtype=x.dtype, device=x.device)
    if col.numel() == 0:
        return col
    # the (Ho, Wo) plane of offset and mask is addressed by one pixel stride
    strides = (*xn.stride(), *on.stride()[:2], on.stride(3), *mn.stride()[:2], mn.stride(3))
    lib = _dcn_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dcn_im2col(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), col.data_ptr(),
        N, Cin, H, W, Ho, Wo, kh, kw, stride, padding, dilation, deform_groups,
        *strides, _DTYPES[x.dtype], stream)
    _cuda.check(lib, err, "dcn im2col kernel launch")
    modulated_deform_conv2d.launches += 1
    return col


def _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups, dg, layout):
    N, Cin, H, W, Cout, kh, kw, Ho, Wo = _geometry(
        x, offset, mask, weight, stride, padding, dilation, groups, dg, layout)
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("dcn kernel: weight and bias must be on x's device")
    if groups != 1:
        raise NotImplementedError("dcn kernel: groups > 1 is not ported to the card "
                                  "(no model of the repo uses it)")
    # one column buffer per call, freed to the allocator when the call
    # returns: 26 DCN layers reuse one block
    col = deform_im2col(x, offset, mask, (kh, kw), stride, padding, dilation, dg, layout)
    return col_product(col, weight, bias, Ho, Wo, layout)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1, padding=1,
                            dilation=1, groups=1, deform_groups=1, layout="NCHW"):
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
    Returns:
      [N, Cout, Ho, Wo] (NHWC: [N, Ho, Wo, Cout]) in x.dtype.
    """
    if x.is_cuda:
        return _dcn_cuda(x, offset, mask, weight, bias, stride, padding, dilation, groups,
                         deform_groups, layout)
    if x.device.type != "cpu":
        raise ValueError(f"dcn: unsupported device {x.device}")
    return modulated_deform_conv2d_plain(x, offset, mask, weight, bias, stride, padding,
                                         dilation, groups, deform_groups, layout)


modulated_deform_conv2d.launches = 0
