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
tensors the three launches of `csrc/flash_attn_int8.cu` (amax, codes,
attention).

`multi_head_attention` takes [B, len, heads * d]: on CUDA the kernels read
each head where it lies and write the merged output, so nothing is copied;
on the CPU (and whenever a wrapper has been swapped for its plain version)
it splits the heads, runs the plain version and merges them.

On CUDA every launch is differentiable through `plain_vjp.with_plain_vjp`:
the backward is the VJP of `qkv_plain` on the saved q, k and v
(`ops/attention.py:80-119` of the JAX package), for the int8 op too
(straight-through: the int8 rounding is not differentiated).

Each op is a registered operator, `bevformer_port::flash_attention` and
`bevformer_port::flash_attention_int8` (q, k, v as [B, len, heads * d] and
`heads`; the int8 one holds all three of its launches): the CUDA
implementation launches the kernels and counts the op, the CPU
implementation is the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda, knobs
from .plain_vjp import register_op, wants_grad, with_plain_vjp

FLASH_HEAD_DIMS = (8, 32, 64)  # micro; tiny/small/base; the wider flash width
INT8_FLASH_HEAD_DIMS = (32, 64)
INT8_BLOCK_K = 256
NEG_INF = -1e30
FLASH_KINDS = ("float32", "bfloat16", "int8")
FLASH_BLOCK_K = 64    # keys a tile of the floating-point kernel
ROWS_PER_WARP = 16    # query rows a warp: the M of mma.sync
SMS = 132             # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448   # dynamic shared memory a block may ask for on Hopper
WARP_CHOICES = (4, 2, 1)  # row groups a block, the first that leaves >= SMS blocks
SPLITS = 4  # warps a row group, each taking a quarter of every kv tile (both sources' kSplits)


def flash_smem_bytes(d: int, kind: str, warps: int) -> int:
    """Dynamic shared memory of one block of `warps` row groups of SPLITS
    warps, as the kernel sources lay it out (each source checks the value it
    is given against its own)."""
    splits = SPLITS
    if kind == "int8":  # two stages of k rows (padded by 16 bytes) and v rows, v transposed,
        # the splits' row maxima and their hand-over of P.V sums and row sums
        return (2 * INT8_BLOCK_K * ((d + 16) + d) + d * (INT8_BLOCK_K + 16)
                + warps * splits * 16 * 4 + warps * splits * 32 * (d // 2 + 2) * 4)
    merge = warps * splits * 32 * (4 + d // 2) * 4  # the end's merge of the splits
    if kind == "float32":  # two stages of k and v tiles, rows padded for the fragment loads
        ks, vs = (8 if d == 8 else d + 8), d + 4
        return max(2 * FLASH_BLOCK_K * (ks + vs) * 4, merge)
    if kind == "bfloat16":  # words a row: k at 8 mod 32 (depth padded to 16), v at 4 mod 8
        dp = max(d, 16)
        ksw = dp // 2 if (dp // 2) % 32 == 8 else dp // 2 + 8
        vsw = d // 2 if (d // 2) % 8 == 4 else d // 2 + 4
        return max(2 * FLASH_BLOCK_K * 2 * (ksw + vsw) * 2, merge)
    raise ValueError(f"flash kind must be one of {FLASH_KINDS}, got {kind!r}")


def flash_launch_geometry(B: int, Lq: int, Lk: int, d: int, kind: str, warps: int = 0) -> dict:
    """The launch of the attention kernel for B (= batch x heads) problems
    of Lq queries and Lk keys of width d.  A row group of `splits` warps owns
    16 query rows; each of its warps takes a quarter of every staged kv tile
    and the group merges them (float) or hands its integer sums over after
    every 256-key block (int8).  A block holds as many row groups (4, 2 or 1)
    as still give at least one block per SM, so no SM idles (the decoder's
    8 x 900 queries: 2 row groups, 232 blocks of 8 warps); where no choice
    reaches that, one row group a block, the most blocks.  Returns grid (x
    over the query rows, y over B), warps (row groups a block), splits,
    threads, rows_per_warp, kv_tile (keys a staged tile) and smem (bytes).
    `warps` names the row groups instead (the bench's comparison of them);
    else the knob FLASH_ROW_GROUPS does, where it is not 0."""
    dims = INT8_FLASH_HEAD_DIMS if kind == "int8" else FLASH_HEAD_DIMS
    if kind not in FLASH_KINDS or d not in dims:
        raise ValueError(f"flash geometry: kind {kind!r} takes head dims {dims}, got {d}")
    if B < 1 or Lq < 1 or Lk < 1:
        raise ValueError(f"flash geometry: empty problem B {B}, Lq {Lq}, Lk {Lk}")
    if warps not in WARP_CHOICES:
        warps = knobs.get("FLASH_ROW_GROUPS")
    if warps not in WARP_CHOICES:
        warps = next((w for w in WARP_CHOICES if -(-Lq // (ROWS_PER_WARP * w)) * B >= SMS),
                     WARP_CHOICES[-1])
    smem = flash_smem_bytes(d, kind, warps)
    assert smem <= SMEM_LIMIT
    return dict(grid=(-(-Lq // (ROWS_PER_WARP * warps)), B), warps=warps, splits=SPLITS,
                threads=32 * warps * SPLITS, rows_per_warp=ROWS_PER_WARP,
                kv_tile=INT8_BLOCK_K if kind == "int8" else FLASH_BLOCK_K, smem=smem)


def qkv_plain(query, key, value):
    """Plain PyTorch version, float32 math.  query [B, Lq, d], key/value
    [B, Lk, d] -> [B, Lq, d] in query.dtype."""
    d = query.shape[-1]
    q = query.float() * (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    logits = torch.einsum("bqd,bkd->bqk", q, key.float())
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, value.float()).to(query.dtype)


def multi_head_attention(query, key, value, num_heads: int, int8: bool = False):
    """[B, len, embed] in, heads of embed / num_heads, [B, q_len, embed]
    out, through `flash_attention` (or, with `int8`, `flash_attention_int8`).
    On CUDA the kernel takes the heads where they lie; otherwise the heads
    are split into the batch, the op runs and the heads are merged."""
    impl = flash_attention_int8 if int8 else flash_attention  # looked up now: may be swapped
    head_split = _HEAD_SPLIT.get(impl)
    if query.is_cuda and head_split is not None:
        return head_split(query.contiguous(), key.contiguous(), value.contiguous(),
                          heads=num_heads)
    return _split_heads(impl, query, key, value, num_heads)


def _split_heads(impl, query, key, value, heads: int):
    """`impl` on [B, len, heads * d] tensors: heads split into the batch,
    the op run, the heads merged."""
    B, q_len, E = query.shape
    kv_len = key.shape[1]
    hd = E // heads

    def split(x, L):
        return x.reshape(B, L, heads, hd).transpose(1, 2).reshape(B * heads, L, hd)

    out = impl(split(query, q_len).contiguous(), split(key, kv_len).contiguous(),
               split(value, kv_len).contiguous())
    return out.reshape(B, heads, q_len, hd).transpose(1, 2).reshape(B, q_len, E)


def qkv_heads_plain(query, key, value, heads: int):
    """`qkv_plain` on [B, len, heads * d] (heads split and merged): the
    function whose VJP is the gradient of every flash launch."""
    return _split_heads(qkv_plain, query, key, value, heads)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _flash_lib():
    lib = _cuda.load("flash_attn")
    if lib.flash_attn_forward.argtypes is None:
        lib.flash_attn_forward.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                           + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
        lib.flash_attn_forward.restype = ctypes.c_int
    return lib


def _check_qkv(what, query, key, value, heads, dims):
    """(bs, Lq, Lk, d) of q [bs, Lq, heads * d], k / v [bs, Lk, heads * d]
    that a kernel takes as they lie: one CUDA device and dtype (float32 or
    bfloat16), contiguous, 16-byte aligned."""
    if query.dtype not in _DTYPES or key.dtype != query.dtype or value.dtype != query.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype, float32 or bfloat16")
    if key.device != query.device or value.device != query.device:
        raise ValueError(f"{what}: q, k, v must be on one CUDA device")
    if not (query.is_contiguous() and key.is_contiguous() and value.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if query.dim() != 3 or key.shape != value.shape or key.dim() != 3:
        raise ValueError(f"{what}: expected q [B, Lq, d] and k, v [B, Lk, d]")
    B, Lq, E = query.shape
    Lk = key.shape[1]
    d = E // heads if heads >= 1 else 0
    if (heads < 1 or d * heads != E or key.shape[0] != B or key.shape[2] != E or d not in dims
            or Lk < 1):
        raise ValueError(
            f"{what}: shapes q {tuple(query.shape)} k {tuple(key.shape)} in {heads} heads "
            f"(head dim must be one of {dims}, kv length >= 1)")
    if any(t.data_ptr() % 16 for t in (query, key, value)):
        raise ValueError(f"{what}: inputs must start on 16-byte boundaries")
    return B, Lq, Lk, d


def _flash_cuda(query, key, value, heads=1):
    B, Lq, Lk, d = _check_qkv("flash kernel", query, key, value, heads, FLASH_HEAD_DIMS)
    out = torch.empty_like(query)
    if out.numel() == 0:
        return out
    _launch_flash(query, key, value, out, heads,
                  flash_launch_geometry(B * heads, Lq, Lk, d, _KINDS[query.dtype]))
    flash_attention.launches += 1
    return out


def _launch_flash(query, key, value, out, heads, geo):
    """The floating-point kernel on checked tensors [B, L, heads * d] with
    launch geometry `geo` (the bench times other row-group counts this way)."""
    B, Lq, E = query.shape
    lib = _flash_lib()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = lib.flash_attn_forward(query.data_ptr(), key.data_ptr(), value.data_ptr(),
                                 out.data_ptr(), B, heads, Lq, key.shape[1], E // heads, E, E, E,
                                 E, _DTYPES[query.dtype], geo["warps"], geo["splits"],
                                 geo["grid"][0], geo["smem"], stream)
    _cuda.check(lib, err, "flash kernel launch")


# the registered operator on [B, L, heads * d]
flash_op = register_op(
    "flash_attention(Tensor query, Tensor key, Tensor value, int heads) -> Tensor",
    qkv_heads_plain, lambda q, k, v, heads: _flash_cuda(q, k, v, heads),
    lambda q, k, v, heads: torch.empty_like(q))


def _flash_heads(query, key, value, heads=1):
    """The floating-point kernel on [B, L, heads * d], differentiable."""
    return with_plain_vjp(lambda q, k, v: flash_op(q, k, v, heads), qkv_heads_plain,
                          (query, key, value), (heads,))


def flash_attention(query, key, value):
    """softmax(q k^T / sqrt(d)) v; query [B, Lq, d], key/value [B, Lk, d]."""
    if query.is_cuda:
        return _flash_heads(query, key, value)
    if query.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {query.device}")
    if wants_grad(query, key, value):
        return qkv_plain(query, key, value)
    return flash_op(query, key, value, 1)


flash_attention.launches = 0


def _f32(x, device):
    """x as a 0-dim float32 tensor on `device`: dividing by it is a true
    division on every device (CUDA turns a Python-scalar divisor into a
    multiplication by its reciprocal, which can sit one ulp off)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def quantize_per_tensor(x):
    """x -> (int8, scale): `scale = max(amax, 1e-12) / 127`,
    `q = clip(round(x / scale), -127, 127)`."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / _f32(127.0, x.device)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_operands(query, key, value):
    """(q8, k8, v8, scales [2] = (sq * sk / sqrt(d), sv / 127)), bit for bit
    the JAX wrapper's on every device."""
    d, dev = query.shape[-1], query.device
    qi, sq = quantize_per_tensor(query)
    ki, sk = quantize_per_tensor(key)
    vi, sv = quantize_per_tensor(value)
    return qi, ki, vi, torch.stack([sq * sk / _f32(float(d) ** 0.5, dev),
                                    sv / _f32(127.0, dev)])


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
        lib.flash_attn_int8_quantize.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p])
        lib.flash_attn_int8_quantize.restype = ctypes.c_int
        lib.flash_attn_int8_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                                + [ctypes.c_longlong] + [ctypes.c_int] * 5
                                                + [ctypes.c_void_p])
        lib.flash_attn_int8_forward.restype = ctypes.c_int
    return lib


_AMAX = {}  # device index -> [uint32 [2, 4] amax slots, the slot of the next call]


def _amax_slot(device):
    """The amax buffer of `device` (zeroed once, when first made) and the
    slot this call uses; the amax launch resets the other slot, the next
    call's."""
    entry = _AMAX.get(device.index)
    if entry is None:
        entry = _AMAX[device.index] = [torch.zeros(2, 4, dtype=torch.int32, device=device), 0]
    slot = entry[1]
    entry[1] ^= 1
    return entry[0], slot


def flash_int8_quantize(query, key, value, heads=1):
    """Launches 1 and 2 of the int8 op on CUDA tensors [bs, L, heads * d]:
    (q8, k8, v8) as [bs * heads, L, d] int8 and scales [2] float32, bit for
    bit `int8_operands` of the head-split tensors."""
    shape = _check_qkv("int8 flash kernel", query, key, value, heads, INT8_FLASH_HEAD_DIMS)
    return _int8_codes(query, key, value, heads, *shape)


def _int8_codes(query, key, value, heads, B, Lq, Lk, d):
    dev = query.device
    q8 = torch.empty((B * heads, Lq, d), dtype=torch.int8, device=dev)
    k8 = torch.empty((B * heads, Lk, d), dtype=torch.int8, device=dev)
    v8 = torch.empty_like(k8)
    scales = torch.empty(2, dtype=torch.float32, device=dev)
    buf, slot = _amax_slot(dev)
    lib = _flash_int8_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attn_int8_quantize(query.data_ptr(), key.data_ptr(), value.data_ptr(),
                                       q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), Lq, Lk,
                                       heads, d, query.numel(), key.numel(), buf.data_ptr(), slot,
                                       float(d) ** 0.5, scales.data_ptr(),
                                       _DTYPES[query.dtype], stream)
    _cuda.check(lib, err, "int8 flash quantization launch")
    return q8, k8, v8, scales


def _flash_int8_cuda(query, key, value, operands=None, heads=1):
    B, Lq, Lk, d = _check_qkv("int8 flash kernel", query, key, value, heads,
                              INT8_FLASH_HEAD_DIMS)
    out = torch.empty_like(query)
    if out.numel() == 0:
        return out
    if operands is None:
        qi, ki, vi, scales = _int8_codes(query, key, value, heads, B, Lq, Lk, d)
    else:
        qi, ki, vi, scales = operands
        if (heads != 1 or any(t.dtype != torch.int8 or not t.is_contiguous()
                              or t.device != query.device for t in (qi, ki, vi))
                or qi.shape != query.shape or ki.shape != key.shape or vi.shape != key.shape
                or scales.dtype != torch.float32 or tuple(scales.shape) != (2,)
                or scales.device != query.device):
            raise ValueError("int8 flash kernel: operands must be contiguous int8 q, k, v of the "
                             "inputs' shapes and a float32 scales [2], on the inputs' device")
    _launch_flash_int8((qi, ki, vi, scales), out, heads,
                       flash_launch_geometry(B * heads, Lq, Lk, d, "int8"))
    flash_attention_int8.launches += 1
    return out


def _launch_flash_int8(operands, out, heads, geo):
    """The int8 attention kernel on checked codes [B * heads, L, d] and
    scales, writing out [B, Lq, heads * d], with launch geometry `geo`."""
    qi, ki, vi, scales = operands
    BH, Lq, d = qi.shape
    lib = _flash_int8_lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.flash_attn_int8_forward(qi.data_ptr(), ki.data_ptr(), vi.data_ptr(),
                                      scales.data_ptr(), out.data_ptr(), BH, heads, Lq,
                                      ki.shape[1], d, heads * d, _DTYPES[out.dtype], geo["warps"],
                                      geo["splits"], geo["grid"][0], geo["smem"], stream)
    _cuda.check(lib, err, "int8 flash kernel launch")


def flash_attention_int8(query, key, value):
    """int8 flash attention with the contract of `flash_attention`: dynamic
    per-tensor int8 quantization of q, k, v, int8 products, float32 online
    softmax.  query [B, Lq, d], key/value [B, Lk, d], d in (32, 64).  (To
    time the attention kernel apart from the quantization,
    `_flash_int8_cuda(query, key, value, operands)` takes
    `int8_operands(query, key, value)` made ahead.)  The kernel's gradient
    is `qkv_plain`'s (straight-through)."""
    if query.is_cuda:
        return _flash_int8_heads(query.contiguous(), key.contiguous(), value.contiguous())
    if query.device.type != "cpu":
        raise ValueError(f"flash_attention_int8: unsupported device {query.device}")
    if wants_grad(query, key, value):
        return flash_attention_int8_plain(query, key, value)
    return flash_int8_op(query, key, value, 1)


flash_attention_int8.launches = 0


# the registered operator on [B, L, heads * d]: the amax, quantize and
# attention launches on CUDA
flash_int8_op = register_op(
    "flash_attention_int8(Tensor query, Tensor key, Tensor value, int heads) -> Tensor",
    lambda q, k, v, heads: _split_heads(flash_attention_int8_plain, q, k, v, heads),
    lambda q, k, v, heads: _flash_int8_cuda(q, k, v, None, heads),
    lambda q, k, v, heads: torch.empty_like(q))


def _flash_int8_heads(query, key, value, heads=1):
    """The int8 operator on [B, L, heads * d], differentiable straight
    through."""
    def launch(q, k, v):
        return flash_int8_op(q, k, v, heads)

    return with_plain_vjp(launch, qkv_heads_plain, (query, key, value), (heads,))


# the wrappers whose kernels take [B, L, heads * d] as it lies (a plain
# version swapped in for a wrapper is not here, so it takes the split path)
_HEAD_SPLIT = {flash_attention: _flash_heads, flash_attention_int8: _flash_int8_heads}
