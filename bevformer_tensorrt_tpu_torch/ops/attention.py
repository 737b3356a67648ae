"""Fused multi-head attention (port of `bevformer_tensorrt_tpu/ops/attention.py`).

`softmax(q @ k^T / sqrt(d)) @ v` over [batch, len, dim] tensors, heads
folded into the batch by the caller.  `flash_attention` is the public
function: for CPU tensors it runs `qkv_plain`; for CUDA tensors it
launches the kernel of `csrc/flash_attn.cu` or raises.

`flash_attention_int8` is the int8 tier: q, k and v are quantized with one
dynamic per-tensor scale each, both products run on int8 with int32 sums,
and the probabilities are requantized as `round(p * 127)` against the
running maximum after each block of `INT8_BLOCK_K` keys.  That block size is
part of the contract (another one rounds differently); it is the JAX
kernel's default.  CPU tensors run `flash_attention_int8_plain`, CUDA
tensors the kernel of `csrc/flash_attn_int8.cu`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

FLASH_HEAD_DIMS = (8, 32, 64)  # micro; tiny/small/base; the wider flash width
INT8_FLASH_HEAD_DIMS = (32, 64)
INT8_BLOCK_K = 256
NEG_INF = -1e30


def qkv_plain(query, key, value):
    """Plain PyTorch version, float32 math.  query [B, Lq, d], key/value
    [B, Lk, d] -> [B, Lq, d] in query.dtype."""
    d = query.shape[-1]
    q = query.float() * (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    logits = torch.einsum("bqd,bkd->bqk", q, key.float())
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, value.float()).to(query.dtype)


def multi_head_attention(query, key, value, num_heads: int, int8: bool = False):
    """Split [B, len, embed] into heads, run `flash_attention` (or, with
    `int8`, `flash_attention_int8`), merge heads."""
    B, q_len, E = query.shape
    kv_len = key.shape[1]
    hd = E // num_heads

    def split(x, L):
        return x.reshape(B, L, num_heads, hd).transpose(1, 2).reshape(B * num_heads, L, hd)

    impl = flash_attention_int8 if int8 else flash_attention
    out = impl(split(query, q_len).contiguous(), split(key, kv_len).contiguous(),
               split(value, kv_len).contiguous())
    return out.reshape(B, num_heads, q_len, hd).transpose(1, 2).reshape(B, q_len, E)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _flash_lib():
    lib = _cuda.load("flash_attn")
    if lib.flash_attn_forward.argtypes is None:
        lib.flash_attn_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _flash_cuda(query, key, value):
    if query.dtype not in _DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError("flash kernel: q, k, v must share one dtype, float32 or bfloat16")
    if key.device != query.device or value.device != query.device:
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if not (query.is_contiguous() and key.is_contiguous() and value.is_contiguous()):
        raise ValueError("flash kernel: inputs must be contiguous")
    if query.dim() != 3 or key.shape != value.shape or key.dim() != 3:
        raise ValueError("flash kernel: expected q [B, Lq, d] and k, v [B, Lk, d]")
    B, Lq, d = query.shape
    Lk = key.shape[1]
    if key.shape[0] != B or key.shape[2] != d or d not in FLASH_HEAD_DIMS or Lk < 1:
        raise ValueError(
            f"flash kernel: shapes q {tuple(query.shape)} k {tuple(key.shape)} "
            f"(head dim must be one of {FLASH_HEAD_DIMS}, kv length >= 1)")
    out = torch.empty_like(query)
    if out.numel() == 0:
        return out
    lib = _flash_lib()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = lib.flash_attn_forward(query.data_ptr(), key.data_ptr(), value.data_ptr(),
                                 out.data_ptr(), B, Lq, Lk, d, _DTYPES[query.dtype], stream)
    _cuda.check(lib, err, "flash kernel launch")
    flash_attention.launches += 1
    return out


def flash_attention(query, key, value):
    """softmax(q k^T / sqrt(d)) v; query [B, Lq, d], key/value [B, Lk, d]."""
    if query.is_cuda:
        return _flash_cuda(query, key, value)
    if query.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {query.device}")
    return qkv_plain(query, key, value)


flash_attention.launches = 0


def quantize_per_tensor(x):
    """x -> (int8, scale): `scale = max(amax, 1e-12) / 127`,
    `q = clip(round(x / scale), -127, 127)`."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_operands(query, key, value):
    """(q8, k8, v8, scales [2] = (sq * sk / sqrt(d), sv / 127))."""
    d = query.shape[-1]
    qi, sq = quantize_per_tensor(query)
    ki, sk = quantize_per_tensor(key)
    vi, sv = quantize_per_tensor(value)
    return qi, ki, vi, torch.stack([sq * sk / float(d) ** 0.5, sv / 127.0])


def flash_attention_int8_plain(query, key, value):
    """Plain PyTorch version of the int8 flash attention: a loop over blocks
    of `INT8_BLOCK_K` keys with the kernel's arithmetic.  The integer
    products run in float64, where they are exact."""
    qi, ki, vi, scales = int8_operands(query, key, value)
    scale_qk, scale_pv = scales[0], scales[1]
    B, Lq, d = query.shape
    m = torch.full((B, Lq, 1), NEG_INF, dtype=torch.float32, device=query.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Lq, d), dtype=torch.float32, device=query.device)
    qd = qi.double()
    for k0 in range(0, key.shape[1], INT8_BLOCK_K):
        kb = ki[:, k0:k0 + INT8_BLOCK_K].double()
        vb = vi[:, k0:k0 + INT8_BLOCK_K].double()
        s = torch.einsum("bqd,bkd->bqk", qd, kb).float() * scale_qk
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        p8 = torch.round(p * 127.0)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p8.double(), vb).float() * scale_pv
    return (acc / l.clamp_min(1e-30)).to(query.dtype)


def _flash_int8_lib():
    lib = _cuda.load("flash_attn_int8")
    if lib.flash_attn_int8_forward.argtypes is None:
        lib.flash_attn_int8_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                                + [ctypes.c_void_p])
        lib.flash_attn_int8_forward.restype = ctypes.c_int
    return lib


def _flash_int8_cuda(query, key, value, operands=None):
    if query.dtype not in _DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError("int8 flash kernel: q, k, v must share one dtype, float32 or bfloat16")
    if key.device != query.device or value.device != query.device:
        raise ValueError("int8 flash kernel: q, k, v must be on one CUDA device")
    if query.dim() != 3 or key.shape != value.shape or key.dim() != 3:
        raise ValueError("int8 flash kernel: expected q [B, Lq, d] and k, v [B, Lk, d]")
    B, Lq, d = query.shape
    Lk = key.shape[1]
    if key.shape[0] != B or key.shape[2] != d or d not in INT8_FLASH_HEAD_DIMS or Lk < 1:
        raise ValueError(
            f"int8 flash kernel: shapes q {tuple(query.shape)} k {tuple(key.shape)} "
            f"(head dim must be one of {INT8_FLASH_HEAD_DIMS}, kv length >= 1)")
    out = torch.empty_like(query)
    if out.numel() == 0:
        return out
    qi, ki, vi, scales = operands if operands is not None else int8_operands(
        query.contiguous(), key.contiguous(), value.contiguous())
    if (any(t.dtype != torch.int8 or not t.is_contiguous() or t.device != query.device
            for t in (qi, ki, vi)) or qi.shape != query.shape or ki.shape != key.shape
            or vi.shape != key.shape or scales.dtype != torch.float32
            or tuple(scales.shape) != (2,) or scales.device != query.device):
        raise ValueError("int8 flash kernel: operands must be contiguous int8 q, k, v of the "
                         "inputs' shapes and a float32 scales [2], on the inputs' device")
    lib = _flash_int8_lib()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = lib.flash_attn_int8_forward(qi.data_ptr(), ki.data_ptr(), vi.data_ptr(),
                                      scales.data_ptr(), out.data_ptr(), B, Lq, Lk, d,
                                      _DTYPES[query.dtype], stream)
    _cuda.check(lib, err, "int8 flash kernel launch")
    flash_attention_int8.launches += 1
    return out


def flash_attention_int8(query, key, value, operands=None):
    """int8 flash attention with the contract of `flash_attention`: dynamic
    per-tensor int8 quantization of q, k, v, int8 products, float32 online
    softmax.  query [B, Lq, d], key/value [B, Lk, d], d in (32, 64).
    `operands` takes `int8_operands(query, key, value)` made ahead of time
    (to time the kernel apart from the quantization); CUDA only."""
    if query.is_cuda:
        return _flash_int8_cuda(query, key, value, operands)
    if query.device.type != "cpu":
        raise ValueError(f"flash_attention_int8: unsupported device {query.device}")
    return flash_attention_int8_plain(query, key, value)


flash_attention_int8.launches = 0
