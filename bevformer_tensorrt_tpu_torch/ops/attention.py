"""Fused multi-head attention (port of `bevformer_tensorrt_tpu/ops/attention.py`).

`softmax(q @ k^T / sqrt(d)) @ v` over [batch, len, dim] tensors, heads
folded into the batch by the caller.  `flash_attention` is the public
function: for CPU tensors it runs `qkv_plain`; for CUDA tensors it
launches the kernel of `csrc/flash_attn.cu` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

FLASH_HEAD_DIMS = (8, 32, 64)  # micro; tiny/small/base; the wider flash width


def qkv_plain(query, key, value):
    """Plain PyTorch version, float32 math.  query [B, Lq, d], key/value
    [B, Lk, d] -> [B, Lq, d] in query.dtype."""
    d = query.shape[-1]
    q = query.float() * (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    logits = torch.einsum("bqd,bkd->bqk", q, key.float())
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, value.float()).to(query.dtype)


def multi_head_attention(query, key, value, num_heads: int):
    """Split [B, len, embed] into heads, run `flash_attention`, merge heads."""
    B, q_len, E = query.shape
    kv_len = key.shape[1]
    hd = E // num_heads

    def split(x, L):
        return x.reshape(B, L, num_heads, hd).transpose(1, 2).reshape(B * num_heads, L, hd)

    out = flash_attention(split(query, q_len).contiguous(), split(key, kv_len).contiguous(),
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
