"""Multi-scale deformable attention (port of `bevformer_tensorrt_tpu/ops/msda.py`).

One op takes raw (pre-softmax) attention logits, computes the softmax over
(levels x points), builds sampling locations `ref + offset / (w, h)`,
bilinearly gathers from every level with torch grid-sample border rules,
and returns the weighted sum.

`multi_scale_deformable_attn` is the public function.  For CPU tensors it
runs `multi_scale_deformable_attn_plain`; for CUDA tensors it launches the
kernel of `csrc/msda.cu` or raises.  On CUDA the launch is differentiable
through `plain_vjp.with_plain_vjp`: the backward is the VJP of the plain
version recomputed from the saved inputs, as the JAX package's custom_vjp
around its kernel (`ops/msda.py:718-744`) does.

`multi_scale_deformable_attn_int8` is the same op from an int8 value table
(the JAX package's `packed="int8"`): the value is quantized with one dynamic
scale per (batch, head) by `quantize_value_table`, the kernel gathers int8
rows, and the scale multiplies the weighted sum once.  By linearity that is
the floating-point op on the dequantized value, which is what its plain
version computes.  The JAX kernel also rounds its combined weights to
bfloat16, which the port does not: the two differ by up to 2^-8 of a weight.
Its gradient is the floating-point plain version's (straight-through).

Both ops are the registered operator `bevformer_port::msda` (its `int8`
flag picks the table): the CUDA implementation launches the kernel and
counts the launch, the CPU implementation is the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _cuda, knobs
from .plain_vjp import register_op, wants_grad, with_plain_vjp

Shapes = Tuple[Tuple[int, int], ...]


def msda_sampling_locations(reference_points, sampling_offsets,
                            spatial_shapes: Sequence[Tuple[int, int]], num_heads: int):
    """reference_points [bs, nq, 1, ppg*2] normalized (x, y);
    sampling_offsets [bs, nq, heads, L*P*2] in pixels of each level.
    Returns [bs, nq, heads, L, P, 2].  Within a level the P points are
    ordered (P // ppg, ppg) with ppg innermost: point p uses reference
    group p % ppg."""
    bs, num_q = reference_points.shape[:2]
    L = len(spatial_shapes)
    ppg = reference_points.shape[-1] // 2
    off = sampling_offsets.reshape(bs, num_q, num_heads, L, -1, ppg, 2)
    ref = reference_points.reshape(bs, num_q, 1, 1, 1, ppg, 2)
    norm = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=off.dtype,
                        device=off.device).reshape(1, 1, 1, L, 1, 1, 2)
    loc = ref + off / norm
    return loc.reshape(bs, num_q, num_heads, L, -1, 2)


def multi_scale_deformable_attn_plain(value, reference_points, sampling_offsets,
                                      attention_weights, spatial_shapes: Shapes):
    """Plain PyTorch version, float32 math per bilinear corner (follows
    `multi_scale_deformable_attn_reference`).  Returns [bs, nq, heads*ch]
    in value.dtype."""
    bs, _, num_heads, ch = value.shape
    num_q = reference_points.shape[1]
    L = len(spatial_shapes)
    P = attention_weights.shape[-1] // L
    weights = torch.softmax(attention_weights.float(), dim=-1).reshape(bs, num_q, num_heads, L, P)
    loc = msda_sampling_locations(reference_points.float(), sampling_offsets.float(),
                                  spatial_shapes, num_heads)
    out = value.new_zeros((bs, num_q, num_heads, ch), dtype=torch.float32)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W].float().permute(0, 2, 1, 3)  # [bs, heads, HW, ch]
        start += H * W
        x = loc[..., lvl, :, 0] * W - 0.5  # [bs, q, heads, P]
        y = loc[..., lvl, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx1, wy1 = x - x0, y - y0
        ix0, iy0 = x0.long(), y0.long()

        def corner(ix, iy, w):
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
            idx = idx.permute(0, 2, 1, 3).reshape(bs, num_heads, num_q * P, 1)
            g = torch.gather(v, 2, idx.expand(-1, -1, -1, ch))
            g = g.reshape(bs, num_heads, num_q, P, ch).permute(0, 2, 1, 3, 4)
            return g * (w * valid)[..., None]

        taps = (corner(ix0, iy0, (1 - wx1) * (1 - wy1))
                + corner(ix0 + 1, iy0, wx1 * (1 - wy1))
                + corner(ix0, iy0 + 1, (1 - wx1) * wy1)
                + corner(ix0 + 1, iy0 + 1, wx1 * wy1))
        out = out + (taps * weights[:, :, :, lvl, :, None]).sum(dim=3)
    return out.reshape(bs, num_q, num_heads * ch).to(value.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_levels: Dict[tuple, torch.Tensor] = {}
MSDA_THREADS = 256         # a block of the kernel; one softmax group of taps fits in it
H100_SMS = 132             # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448        # dynamic shared memory one block may opt into on Hopper


MSDA_MAX_CH = 128          # channels a block blends; wider rows are split on a grid axis


def msda_launch_geometry(bs: int, nq: int, heads: int, ch: int, L: int, P: int,
                         value_esz: int, value_ptr: int = 0, sms: int = H100_SMS) -> dict:
    """How `csrc/msda.cu` is launched for a problem: `lpp`, the taps of a
    (query, head) that one phase-1 pass takes, padded to a power of two (at
    most MSDA_THREADS), and `passes` = ceil(L*P / lpp) (more than one only
    past MSDA_THREADS taps, or where the block's shared memory forces it;
    then the softmax's max and sum come from all the taps first and each
    pass adds into the same output); `qt` queries a block, all their heads
    (MSDA_TAPS_PER_BLOCK taps, fewer where that would leave fewer than
    MSDA_MIN_BLOCKS blocks; 1 before `lpp` is lowered); `cch`, the channels
    a block blends (`ch`, or MSDA_MAX_CH for wider rows, whose chunks,
    `chunks` of them, are a grid axis); `vw`, the bytes of a value row each
    lane loads (16 where the chunk's width and the table's address allow,
    else the largest power of two that they do); `seg`, the row groups that
    share one output in the blend: the fewest that still give every warp of
    the block an output, so that one warp instruction reads the rows of
    neighbouring heads of one query (adjacent in the value's layout where
    the heads sample nearby keys, as the model's do) and few shuffles
    combine the shares; `smem`, 8 bytes for each of the four corners of
    every tap of the block, and 16 after each output's (a bank shift
    between outputs), and with several passes a float32 sum of each output's
    chunk and its softmax stats.  Raises where the problem is empty."""
    LP = L * P
    if LP < 1 or ch < 1 or heads < 1:
        raise ValueError(f"msda kernel: {L} levels x {P} points, {heads} heads, ch {ch}: empty")
    chunks = -(-ch // MSDA_MAX_CH)
    cch = ch if chunks == 1 else MSDA_MAX_CH
    lpp = min(1 << (LP - 1).bit_length(), MSDA_THREADS)
    min_blocks = knobs.get("MSDA_BLOCKS_PER_SM") * sms
    qt = max(1, min(nq, knobs.get("MSDA_TAPS_PER_BLOCK") // (heads * lpp),
                    -(-bs * nq // min_blocks)))

    def smem_of(qt, lpp):
        # two int2 of padding after each output's corners
        multi = qt * heads * (8 + 4 * cch) if -(-LP // lpp) > 1 else 0
        return 8 * qt * heads * (4 * lpp + 2) + multi

    while smem_of(qt, lpp) > SMEM_LIMIT and qt > 1:
        qt = 1
    while smem_of(qt, lpp) > SMEM_LIMIT and lpp > 1:
        lpp //= 2
    smem = smem_of(qt, lpp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"msda kernel: {heads} heads need {smem} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    # every chunk's row (the last may be narrower) and address takes vw
    tail = ch - (chunks - 1) * cch
    vw = 16
    while (cch * value_esz) % vw or (tail * value_esz) % vw or value_ptr % vw:
        vw //= 2
    lanes = cch * value_esz // vw
    rpw = 1  # rows one warp instruction reads
    while 2 * rpw * lanes <= 32:
        rpw *= 2
    seg = 1
    while seg < rpw and rpw // seg * (MSDA_THREADS // 32) > qt * heads:
        seg *= 2
    return dict(qt=qt, threads=MSDA_THREADS, lpp=lpp, vw=vw, seg=seg, smem=smem,
                lanes_per_row=lanes, rows_per_warp=rpw, blocks=bs * -(-nq // qt) * chunks,
                passes=-(-LP // lpp), cch=cch, chunks=chunks)


def _level_table(spatial_shapes: Shapes, device) -> torch.Tensor:
    """[L, 3] int32 (h, w, start) on the device, made once per shape set."""
    key = (tuple(spatial_shapes), device)
    t = _levels.get(key)
    if t is None:
        rows, start = [], 0
        for h, w in spatial_shapes:
            rows.append((h, w, start))
            start += h * w
        t = torch.tensor(rows, dtype=torch.int32, device=device)
        _levels[key] = t
    return t


def quantize_value_table(value):
    """value [bs, keys, heads, ch] -> (int8 of the same shape, scale
    [bs, heads] float32): `s = max(amax over the head's keys and channels,
    1e-12) / 127`, `q = clip(round(v / s), -127, 127)`."""
    v = value.float()
    scale = v.abs().amax(dim=(1, 3)).clamp_min(1e-12) / v.new_full((), 127.0)  # exact on CUDA
    q = torch.round(v / scale[:, None, :, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def multi_scale_deformable_attn_int8_plain(value, reference_points, sampling_offsets,
                                           attention_weights, spatial_shapes: Shapes):
    """Plain PyTorch version of the int8-table op: the floating-point plain
    path on the dequantized int8 value.  Returns value.dtype."""
    q, scale = quantize_value_table(value)
    deq = q.float() * scale[:, None, :, None]
    return multi_scale_deformable_attn_plain(
        deq, reference_points, sampling_offsets, attention_weights, spatial_shapes
    ).to(value.dtype)


def _msda_lib():
    lib = _cuda.load("msda")
    if lib.msda_forward.argtypes is None:
        lib.msda_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 16
                                     + [ctypes.c_void_p])
        lib.msda_forward.restype = ctypes.c_int
        lib.msda_int8_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 16
                                          + [ctypes.c_void_p])
        lib.msda_int8_forward.restype = ctypes.c_int
    return lib


def _msda_cuda(value, reference_points, sampling_offsets, attention_weights,
               spatial_shapes: Shapes, int8_table=None):
    """Launch the kernel.  `int8_table` is None for the floating-point
    table, True to quantize `value` here, or a (q, scale) pair made by
    `quantize_value_table(value)` ahead of time."""
    if value.dtype not in _DTYPES:
        raise TypeError(f"msda kernel: value dtype {value.dtype} is not float32 or bfloat16")
    if sampling_offsets.dtype != value.dtype or attention_weights.dtype != value.dtype:
        raise TypeError("msda kernel: offsets and logits must have the value's dtype")
    if reference_points.dtype != torch.float32:
        raise TypeError("msda kernel: reference_points must be float32")
    tensors = (value, reference_points, sampling_offsets, attention_weights)
    if any(t.device != value.device for t in tensors):
        raise ValueError("msda kernel: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda kernel: inputs must be contiguous")
    if value.dim() != 4:
        raise ValueError(f"msda kernel: value must be [bs, keys, heads, ch], got {tuple(value.shape)}")
    bs, nk, heads, ch = value.shape
    nq = reference_points.shape[1]
    L = len(spatial_shapes)
    ppg = reference_points.shape[-1] // 2
    LP = attention_weights.shape[-1]
    P = LP // L
    if nk != sum(h * w for h, w in spatial_shapes):
        raise ValueError("msda kernel: value keys do not match spatial_shapes")
    if (tuple(reference_points.shape) != (bs, nq, 1, 2 * ppg)
            or tuple(attention_weights.shape) != (bs, nq, heads, LP)
            or tuple(sampling_offsets.shape) != (bs, nq, heads, 2 * LP)
            or LP != L * P or P % ppg):
        raise ValueError(
            "msda kernel: shapes value %s ref %s off %s attn %s do not fit L=%d"
            % (tuple(value.shape), tuple(reference_points.shape),
               tuple(sampling_offsets.shape), tuple(attention_weights.shape), L))
    out = torch.empty((bs, nq, heads * ch), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    table = value
    if int8_table is not None:
        q, scale = quantize_value_table(value) if int8_table is True else int8_table
        if (q.dtype != torch.int8 or q.shape != value.shape or not q.is_contiguous()
                or scale.dtype != torch.float32 or tuple(scale.shape) != (bs, heads)
                or not scale.is_contiguous() or q.device != value.device
                or scale.device != value.device):
            raise ValueError("msda int8 kernel: the table must be int8 of the value's shape "
                             "with a float32 scale [bs, heads], both on the value's device")
        table = q
    geo = msda_launch_geometry(bs, nq, heads, ch, L, P, table.element_size(), table.data_ptr(),
                               torch.cuda.get_device_properties(value.device).multi_processor_count)
    lib = _msda_lib()
    levels = _level_table(spatial_shapes, value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    tail = (reference_points.data_ptr(), sampling_offsets.data_ptr(),
            attention_weights.data_ptr(), levels.data_ptr(), out.data_ptr(),
            bs, nk, nq, heads, ch, L, P, ppg, _DTYPES[value.dtype],
            geo["qt"], geo["threads"], geo["lpp"], geo["vw"], geo["seg"], geo["passes"],
            geo["cch"], stream)
    if int8_table is not None:
        err = lib.msda_int8_forward(q.data_ptr(), scale.data_ptr(), *tail)
        _cuda.check(lib, err, "msda int8 kernel launch")
        multi_scale_deformable_attn_int8.launches += 1
    else:
        err = lib.msda_forward(value.data_ptr(), *tail)
        _cuda.check(lib, err, "msda kernel launch")
        multi_scale_deformable_attn.launches += 1
    return out


def _flat(spatial_shapes: Shapes) -> List[int]:
    return [int(n) for hw in spatial_shapes for n in hw]


def _pairs(flat: Sequence[int]) -> Shapes:
    return tuple(zip(flat[0::2], flat[1::2]))


def _msda_op_cpu(value, reference_points, sampling_offsets, attention_weights, spatial_shapes,
                 int8):
    plain = multi_scale_deformable_attn_int8_plain if int8 else multi_scale_deformable_attn_plain
    return plain(value, reference_points, sampling_offsets, attention_weights,
                 _pairs(spatial_shapes))


def _msda_op_cuda(value, reference_points, sampling_offsets, attention_weights,
                  spatial_shapes, int8):
    return _msda_cuda(value, reference_points, sampling_offsets, attention_weights,
                      _pairs(spatial_shapes), int8_table=True if int8 else None)


def _msda_op_fake(value, reference_points, sampling_offsets, attention_weights,
                  spatial_shapes, int8):
    return value.new_empty((value.shape[0], reference_points.shape[1],
                            value.shape[2] * value.shape[3]))


# the registered operator: `spatial_shapes` flattened (h0, w0, h1, ...),
# `int8` the int8 value table
msda_op = register_op(
    "msda(Tensor value, Tensor reference_points, Tensor sampling_offsets, "
    "Tensor attention_weights, int[] spatial_shapes, bool int8) -> Tensor",
    _msda_op_cpu, _msda_op_cuda, _msda_op_fake)


def _msda_kernel(value, reference_points, sampling_offsets, attention_weights,
                 spatial_shapes: Shapes, int8: bool):
    """The operator's launch, differentiable through the float plain
    version; `int8` picks the int8 value table."""
    def launch(*tensors):
        return msda_op(*tensors, _flat(spatial_shapes), int8)

    return with_plain_vjp(launch, multi_scale_deformable_attn_plain,
                          (value, reference_points, sampling_offsets, attention_weights),
                          (spatial_shapes,))


def multi_scale_deformable_attn(value, reference_points, sampling_offsets,
                                attention_weights, spatial_shapes: Shapes):
    """Fused multi-scale deformable attention.

    Args:
      value: [bs, num_keys, heads, ch], levels concatenated along num_keys
        in `spatial_shapes` order (row-major h*w each).
      reference_points: [bs, num_q, 1, ppg*2] normalized [0, 1].
      sampling_offsets: [bs, num_q, heads, L*P*2] raw pixel offsets.
      attention_weights: [bs, num_q, heads, L*P] raw logits (softmax inside).
      spatial_shapes: tuple of (h, w) per level.
    Returns:
      [bs, num_q, heads*ch] in value.dtype.
    """
    if value.is_cuda:
        return _msda_kernel(value, reference_points, sampling_offsets, attention_weights,
                            tuple(spatial_shapes), False)
    if value.device.type != "cpu":
        raise ValueError(f"msda: unsupported device {value.device}")
    if wants_grad(value, reference_points, sampling_offsets, attention_weights):
        return multi_scale_deformable_attn_plain(value, reference_points, sampling_offsets,
                                                 attention_weights, spatial_shapes)
    return msda_op(value, reference_points, sampling_offsets, attention_weights,
                   _flat(spatial_shapes), False)


multi_scale_deformable_attn.launches = 0


def multi_scale_deformable_attn_int8(value, reference_points, sampling_offsets,
                                     attention_weights, spatial_shapes: Shapes):
    """`multi_scale_deformable_attn` from an int8 value table: the value
    (float32 or bfloat16, same arguments) is quantized per (batch, head)
    here, and the kernel gathers the int8 rows.  (To time the kernel apart
    from the quantization, `_msda_cuda(..., int8_table=(q, scale))` takes a
    table made ahead by `quantize_value_table`.)  The kernel's gradient is
    the floating-point op's (straight-through)."""
    if value.is_cuda:
        return _msda_kernel(value, reference_points, sampling_offsets, attention_weights,
                            tuple(spatial_shapes), True)
    if value.device.type != "cpu":
        raise ValueError(f"msda: unsupported device {value.device}")
    if wants_grad(value, reference_points, sampling_offsets, attention_weights):
        return multi_scale_deformable_attn_int8_plain(value, reference_points, sampling_offsets,
                                                      attention_weights, spatial_shapes)
    return msda_op(value, reference_points, sampling_offsets, attention_weights,
                   _flat(spatial_shapes), True)


multi_scale_deformable_attn_int8.launches = 0
