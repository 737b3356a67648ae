"""int8 matrix product with a fused dequantization
(port of `bevformer_tensorrt_tpu/ops/pallas/int8_matmul.py`).

`int8_matmul(x, w, x_scale, w_scale)` computes
`(x @ w.T) * (x_scale * w_scale[n])` from int8 operands with exact int32
accumulation.  Both operands keep the contraction axis last (x [M, K],
w [N, K], the layout of a dense weight), which is what the tensor cores
read.  For CPU tensors it runs `int8_matmul_plain`; for CUDA tensors it
launches the kernel of `csrc/int8_gemm.cu` or raises.

The kernel runs in one of the tile configurations of `GEMM_CONFIGS`, which
`gemm_config` picks from the shape alone; the operands reach it through TMA
tensor maps whose arguments `tensor_map_args` states and checks.

The product has no gradient (nor has the JAX package's): with grad mode on,
an input that requires grad makes the call raise on every device, rather
than return a result cut off from the graph.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda

K_ALIGN = 16  # a TMA row stride is a multiple of 16 bytes
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STAGE_K = 128  # bytes of K per pipeline stage: one 128-byte swizzle row
SMEM_LIMIT = 232448  # dynamic shared memory one block may opt into on Hopper
# name: (consumer warpgroups, tile rows BM = 64 x consumers, tile columns BN,
# pipeline stages); the order is the `config` index of `int8_gemm_forward`
GEMM_CONFIGS = {
    "128x128": (2, 128, 128, 4),   # large products
    "128x64": (2, 128, 64, 6),     # N <= 64: the stem and stage 1
    "64x64": (1, 64, 64, 4),       # launch-sized products, two blocks an SM
}
SMALL_OUTPUTS = 132 * 128 * 128  # fewer outputs than one 128x128 tile per SM
SMALL_K = 1024


def gemm_config(M: int, N: int, K: int) -> str:
    """The tile configuration for an (M, K, N) product: a launch-sized
    product (fewer outputs than one 128x128 tile per SM, and K under
    SMALL_K) takes 64x64 tiles, to spread over more SMs; otherwise 128x64
    for N <= 64, else 128x128 (at K 4608 the larger tiles win even where
    they leave SMs idle: 15.9 against 21.3 us for (2250, 4608, 512) on an
    H100)."""
    if M * N < SMALL_OUTPUTS and K < SMALL_K:
        return "64x64"
    return "128x64" if N <= 64 else "128x128"


def gemm_smem_bytes(config: str) -> int:
    """Dynamic shared memory of one block, as `Cfg::SMEM` in the source:
    alignment slack, the ring of x and w tiles, the float32 staging of each
    consumer's 64 output rows (padded by 8), and two mbarriers a stage."""
    nc, bm, bn, stages = GEMM_CONFIGS[config]
    return 1024 + stages * (bm + bn) * STAGE_K + nc * 64 * (bn + 8) * 4 + 2 * stages * 8


def tensor_map_args(rows: int, K: int, data_ptr: int, box_rows: int):
    """What `cuTensorMapEncodeTiled` receives for an int8 [rows, K] operand
    (K contiguous) read in boxes of STAGE_K bytes x `box_rows` rows with the
    128-byte swizzle: (global dims, global strides in bytes, box dims),
    innermost first.  Raises where TMA does not take the operand."""
    if rows < 1 or K < K_ALIGN:
        raise ValueError(f"int8 gemm kernel: operand [{rows}, {K}] is empty")
    if K % K_ALIGN or data_ptr % 16:
        raise ValueError(f"int8 gemm kernel: TMA needs 16-byte rows and a 16-byte aligned "
                         f"base, got K {K} at address {data_ptr:#x}")
    if rows >= 2 ** 31 or K >= 2 ** 31:
        raise ValueError(f"int8 gemm kernel: operand [{rows}, {K}] exceeds int32 extents")
    if not 1 <= box_rows <= 256:
        raise ValueError(f"int8 gemm kernel: box of {box_rows} rows is not in [1, 256]")
    return (K, rows), (K,), (STAGE_K, box_rows)


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
        lib.int8_gemm_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
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
    config = gemm_config(M, N, K + pad)
    _, bm, bn, _ = GEMM_CONFIGS[config]
    tensor_map_args(M, K + pad, x.data_ptr(), bm)
    tensor_map_args(N, K + pad, w.data_ptr(), bn)
    lib = _gemm_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int8_gemm_forward(x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
                                w_scale.data_ptr(), out.data_ptr(), M, N, K + pad,
                                _OUT_DTYPES[out_dtype], list(GEMM_CONFIGS).index(config),
                                stream)
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
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (x, w, x_scale, w_scale)):
        raise RuntimeError("int8_matmul has no gradient: an input requires grad (run the int8 "
                           "tier under torch.no_grad(), or train through the QDQ tier)")
    if x.is_cuda:
        return _int8_matmul_cuda(x, w, x_scale, w_scale, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return int8_matmul_plain(x, w, x_scale, w_scale, out_dtype)


int8_matmul.launches = 0
