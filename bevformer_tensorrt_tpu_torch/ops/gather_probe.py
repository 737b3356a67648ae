"""Gather probes: the bare row gather and the gather with the corner blend
that multi-scale deformable attention is built on, as kernels of their own
(`csrc/gather_probe.cu`).  The kernel bench tool (`tools/kernel_bench.py`)
times them over a workload whose locality is a parameter, and beside the
MSDA kernel at the same indices, to say how much of that kernel's time is
the gather.  They take the place of the JAX package's TPU probes
(`tools/kernel_bench*.py`, `tools/gather_bench.py`); no model calls them.

  gather_rows(table [B, keys, ch], idx [B, n])            -> [B, n, ch]
  gather_blend(table [B, keys, ch], idx, w [B, nq, taps, 4]) -> [B, nq, ch]
      = sum over taps and corners of w * table[idx], float32 sums

Indices outside [0, keys) are clamped into the table.  CPU tensors run the
plain versions (`torch.gather`, and a gather followed by an einsum); CUDA
tensors launch the kernels or the call raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from .msda import H100_SMS

ROW = 32  # channels of a gather_blend row
_BLEND_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
BLEND_THREADS = 256      # a gather_blend block
BLEND_WARPS_PER_SM = 32  # warp rounds an SM should get before row groups share outputs
BLEND_BLOCKS_PER_SM = 4  # blocks a launch is spread over, per SM, where it has the queries
BLEND_QUERIES = 256      # consecutive queries a block owns, at most


def make_workload(rng, B: int, nq: int, taps: int, keys: int, span: int, row: int = 0):
    """Sorted-ish gather indices with a set locality (the port's copy of the
    TPU probes' `make_workload`): the `nq * taps` taps of a table are cut
    into rows of 128 consecutive taps, and the tap indices of one row fall
    into `span` consecutive 128-key panels whose first panel grows along the
    table.  Returns (idx int32 [B, nq, taps, 4], w float32 [B, nq, taps, 4])
    from the numpy `rng`: corner 0 is the tap's index k and corners 1-3 are
    k + 1, k + row and k + row + 1 clipped to the table (`row` = the width of
    the sampled map; 0 puts all four corners on k), and w is uniform [0, 1).
    """
    if nq * taps % 128:
        raise ValueError(f"make_workload: nq * taps = {nq * taps} is not a multiple of 128")
    if keys < 128 or span < 1:
        raise ValueError("make_workload: needs at least one 128-key panel and span >= 1")
    n_rows = nq * taps // 128
    n_panels = keys // 128
    base = np.sort(rng.integers(0, max(n_panels - span, 1), (B, n_rows)), axis=1)
    jitter = rng.integers(0, span * 128, (B, n_rows, 128))
    k = np.minimum(base[..., None] * 128 + jitter, keys - 1).reshape(B, nq, taps)
    corners = np.stack([k, k + 1, k + row, k + row + 1] if row else [k] * 4, axis=-1)
    idx = np.minimum(corners, keys - 1).astype(np.int32)
    w = rng.random((B, nq, taps, 4), dtype=np.float32)
    return idx, w


def _check_table(table, idx, what):
    if table.dim() != 3:
        raise ValueError(f"{what}: table must be [B, keys, ch], got {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{what}: table and idx must be on one device")
    if idx.shape[0] != table.shape[0]:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} does not index the {table.shape[0]} "
                         "tables")


def gather_rows_plain(table, idx):
    """Plain PyTorch version of `gather_rows`: one `torch.gather`."""
    _check_table(table, idx, "gather_rows")
    k = idx.long().clamp(0, table.shape[1] - 1)
    return torch.gather(table, 1, k[:, :, None].expand(-1, -1, table.shape[2]))


def gather_blend_plain(table, idx, w):
    """Plain PyTorch version of `gather_blend`: gather every row, then one
    einsum with the weights, in float32."""
    _check_table(table, idx, "gather_blend")
    B, nq = idx.shape[:2]
    rows = gather_rows_plain(table, idx.reshape(B, -1)).reshape(B, nq, -1, table.shape[2])
    return torch.einsum("bqe,bqec->bqc", w.reshape(B, nq, -1).float(), rows.float())


def gather_blend_geometry(B: int, nq: int, entries: int, esz: int) -> dict:
    """How `csrc/gather_probe.cu` launches `gather_blend` for B tables of nq
    queries with `entries` (taps x 4) each and rows of 32 values of `esz`
    bytes: each lane loads 16 bytes of a row, so a row group of
    `lanes_per_row` lanes reads a row and a warp instruction reads
    `rows_per_warp` rows; a group loads `chunk` entries' indices and weights
    at once (16 bytes a lane).  `seg`, the row groups that share one output
    (each a 1 / seg share of its chunks, summed by shuffles): 1, doubled
    while the outputs give the card fewer than BLEND_WARPS_PER_SM warp
    rounds an SM and the output has chunks to share.  `qt`, the consecutive
    queries of one table a block owns: whole rounds of its warps (a
    round is 8 warps x rows_per_warp / seg outputs), as many as
    BLEND_QUERIES holds, halved while the launch would have fewer than
    BLEND_BLOCKS_PER_SM blocks an SM.  No shared memory."""
    if B < 1 or nq < 1 or entries < 4 or entries % 4 or esz not in (1, 2, 4):
        raise ValueError(f"gather_blend kernel: B {B}, nq {nq}, entries {entries}, rows of "
                         f"{esz}-byte values: not a problem it takes")
    lanes = ROW * esz // 16
    rpw = 32 // lanes
    chunk = 4 * lanes
    chunks = -(-entries // chunk)
    seg = 1
    while 2 * seg <= min(rpw, chunks) and B * nq * seg < rpw * H100_SMS * BLEND_WARPS_PER_SM:
        seg *= 2
    per_round = BLEND_THREADS // 32 * rpw // seg
    rounds = max(1, BLEND_QUERIES // per_round)
    while rounds > 1 and B * -(-nq // (per_round * rounds)) < BLEND_BLOCKS_PER_SM * H100_SMS:
        rounds //= 2
    qt = per_round * rounds
    return dict(threads=BLEND_THREADS, qt=qt, seg=seg, lanes_per_row=lanes, rows_per_warp=rpw,
                chunk=chunk, blocks=B * -(-nq // qt), smem=0)


def _lib():
    lib = _cuda.load("gather_probe")
    if lib.gather_rows.argtypes is None:
        lib.gather_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.gather_rows.restype = ctypes.c_int
        lib.gather_blend.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.gather_blend.restype = ctypes.c_int
    return lib


def gather_rows(table, idx):
    """out[b, i, :] = table[b, idx[b, i], :] in the table's dtype.  table
    [B, keys, ch] (any dtype whose row is a multiple of 16 bytes), idx
    [B, n] int32, both contiguous."""
    _check_table(table, idx, "gather_rows")
    if idx.dim() != 2:
        raise ValueError(f"gather_rows: idx must be [B, n], got {tuple(idx.shape)}")
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"gather_rows: unsupported device {table.device}")
        return gather_rows_plain(table, idx)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows kernel: inputs must be contiguous")
    B, keys, ch = table.shape
    row_bytes = ch * table.element_size()
    if row_bytes % 16 or keys >= 2 ** 31:
        raise ValueError(f"gather_rows kernel: a row of {row_bytes} bytes is not a multiple of "
                         "16, or the table has 2^31 keys or more")
    out = torch.empty((B, idx.shape[1], ch), dtype=table.dtype, device=table.device)
    if out.numel() == 0 or keys == 0:
        return out
    lib = _lib()
    err = lib.gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, keys,
                          idx.shape[1], row_bytes,
                          torch.cuda.current_stream(table.device).cuda_stream)
    _cuda.check(lib, err, "gather_rows kernel launch")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_blend(table, idx, w):
    """out[b, q, :] = sum over taps t and corners c of
    w[b, q, t, c] * table[b, idx[b, q, t, c], :], float32.  table
    [B, keys, 32] float32, bfloat16 or int8; idx int32 and w float32
    [B, nq, taps, 4]; all contiguous."""
    _check_table(table, idx, "gather_blend")
    if idx.dim() != 4 or idx.shape != w.shape:
        raise ValueError(f"gather_blend: idx {tuple(idx.shape)} and w {tuple(w.shape)} must "
                         "both be [B, nq, taps, corners]")
    if w.dtype != torch.float32 or w.device != table.device:
        raise TypeError("gather_blend: w must be float32 on the table's device")
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"gather_blend: unsupported device {table.device}")
        return gather_blend_plain(table, idx, w)
    if table.dtype not in _BLEND_DTYPES:
        raise TypeError(f"gather_blend kernel: table dtype {table.dtype} is not float32, "
                        "bfloat16 or int8")
    if table.shape[2] != ROW:
        raise ValueError(f"gather_blend kernel: rows must have {ROW} channels, got "
                         f"{table.shape[2]}")
    if not (table.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_blend kernel: inputs must be contiguous")
    B, keys, ch = table.shape
    nq, entries = idx.shape[1], idx.shape[2] * idx.shape[3]
    if keys >= 2 ** 31 // ROW or nq >= 2 ** 31 or entries >= 2 ** 31:
        raise ValueError("gather_blend kernel: shape beyond the kernel's index range")
    if any(t.data_ptr() % 16 for t in (table, idx, w)):
        raise ValueError("gather_blend kernel: table, idx and w must start 16-byte aligned")
    out = torch.empty((B, nq, ch), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if entries == 0 or keys == 0:
        return out.zero_()
    geo = gather_blend_geometry(B, nq, entries, table.element_size())
    lib = _lib()
    err = lib.gather_blend(table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), B,
                           keys, nq, entries, _BLEND_DTYPES[table.dtype], geo["qt"], geo["seg"],
                           geo["threads"], torch.cuda.current_stream(table.device).cuda_stream)
    _cuda.check(lib, err, "gather_blend kernel launch")
    gather_blend.launches += 1
    return out


gather_blend.launches = 0
