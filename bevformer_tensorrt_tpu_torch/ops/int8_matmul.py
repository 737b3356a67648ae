"""int8 matrix product with a fused dequantization
(port of `bevformer_tensorrt_tpu/ops/pallas/int8_matmul.py`).

`int8_matmul(x, w, x_scale, w_scale)` computes
`(x @ w.T) * (x_scale * w_scale[n])` from int8 operands with exact int32
accumulation.  Both operands keep the contraction axis last (x [M, K],
w [N, K], the layout of a dense weight), which is what the tensor cores
read.  For CPU tensors it runs `int8_matmul_plain`; for CUDA tensors it
launches the kernel of `csrc/int8_gemm.cu` or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda

K_ALIGN = 16  # the kernel loads 16 bytes of K at a time
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x, w, x_scale, w_scale, out_dtype=torch.float32):
    """Plain PyTorch version.  The product runs in float64, where sums of
    int8 products are exact up to K of 5e11 (float32 holds only 2^24, less
    than K = 4608 can reach), then rounds to float32 as the int32
    accumulator does."""
    acc = (x.double() @ w.double().t()).float()
    scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device) * w_scale.float()
    return (acc * scale[None, :]).to(out_dtype)


def _gemm_lib():
    lib = _cuda.load("int8_gemm")
    if lib.int8_gemm_forward.argtypes is None:
        lib.int8_gemm_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
        lib.int8_gemm_forward.restype = ctypes.c_int
    return lib


def _int8_matmul_cuda(x, w, x_scale, w_scale, out_dtype):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("int8 gemm kernel: x and w must be int8")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8 gemm kernel: out_dtype {out_dtype} is not float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"int8 gemm kernel: expected x [M, K] and w [N, K], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[0]
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device).reshape(())
    if (w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (N,)
            or not w_scale.is_contiguous()):
        raise ValueError("int8 gemm kernel: w_scale must be a contiguous float32 [N]")
    if any(t.device != x.device for t in (w, x_scale, w_scale)):
        raise ValueError("int8 gemm kernel: all inputs must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8 gemm kernel: x and w must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    pad = (-K) % K_ALIGN
    if pad:  # zero columns add nothing to the sums
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, pad))
    if x.data_ptr() % K_ALIGN:  # a view into the middle of a storage
        x = x.clone()
    if w.data_ptr() % K_ALIGN:
        w = w.clone()
    lib = _gemm_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int8_gemm_forward(x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
                                w_scale.data_ptr(), out.data_ptr(), M, N, K + pad,
                                _OUT_DTYPES[out_dtype], stream)
    _cuda.check(lib, err, "int8 gemm kernel launch")
    int8_matmul.launches += 1
    return out


def int8_matmul(x, w, x_scale, w_scale, out_dtype=torch.float32):
    """Dequantized int8 product.

    Args:
      x: [M, K] int8 activations.
      w: [N, K] int8 weights (one row per output channel).
      x_scale: scalar float32 activation scale (tensor or number).
      w_scale: [N] float32 per-output-channel weight scales.
    Returns:
      [M, N] in `out_dtype`: int32-exact sums times `x_scale * w_scale[n]`.
    """
    if x.is_cuda:
        return _int8_matmul_cuda(x, w, x_scale, w_scale, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return int8_matmul_plain(x, w, x_scale, w_scale, out_dtype)


int8_matmul.launches = 0
