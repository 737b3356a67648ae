"""The shapes at which the models launch the port's kernels, seeded inputs at
those shapes, what each launch must move and compute, and the timer: shared
by `chip_smoke.py` and `tools/kernel_bench.py`.

A bound is the least time the card could take for the same work: the larger
of the bytes the function must move (each input read once, each output
written once) over the memory rate and its operations over the peak rate of
their type.  The rates are the published peaks of one NVIDIA H100 SXM:
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s
bfloat16, 1979 TOP/s int8, 495 TFLOP/s TF32 (a float32 product as split
TF32 takes three), and the special-function units' 16 exponentials a clock
per SM at the 1.83 GHz those peaks assume (132 SMs: 3.87 T a second).
"""
from __future__ import annotations

import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12,
              "split_tf32": 495e12 / 3}
EXP_PER_S = 16 * 132 * 1.83e9
SLEEP_CYCLES = 20_000_000  # ~10 ms of device sleep ahead of a timed batch

MSDA_SHAPES = {
    # name: (bs, spatial_shapes, nq, P, ppg, launches per tiny frame, per base frame)
    "tsa": (2, ((50, 50),), 2500, 4, 1, 3, 0),
    "sca": (6, ((15, 25),), 896, 8, 4, 3, 0),
    "decoder": (1, ((50, 50),), 900, 4, 1, 6, 0),
    "tsa_base": (2, ((200, 200),), 40000, 4, 1, 0, 6),
    "base4": (6, ((116, 200), (58, 100), (29, 50), (15, 25)), 14080, 8, 4, 0, 6),
    "decoder_base": (1, ((200, 200),), 900, 4, 1, 0, 6),
}
MSDA_EDGE_SHAPES = {
    # no model launches these: the kernel's other row widths, taps past a
    # warp, taps past a block (two phase-1 passes), rows past 128 channels
    # (two channel chunks) and heads x taps past a block's shared memory
    # (four passes of 64 taps); name: (bs, spatial_shapes, nq, P, ppg, ch, heads)
    "ch16": (2, ((30, 40), (15, 20)), 1000, 4, 2, 16, 8),
    "ch64": (2, ((50, 50),), 2500, 4, 1, 64, 8),
    "lp64": (2, ((40, 50), (20, 25), (10, 13), (5, 7)), 700, 16, 4, 32, 8),
    "lp320": (2, ((40, 50), (20, 25), (10, 13), (5, 7)), 400, 80, 4, 32, 8),
    "ch256": (2, ((30, 40), (15, 20)), 1000, 4, 2, 256, 8),
    "heads64": (1, ((20, 25), (10, 13), (5, 7), (3, 4)), 200, 64, 4, 32, 64),
}
FLASH_SHAPES = {
    # name: (B, Lq, Lk, d, launches per tiny frame, per base frame)
    "decoder": (8, 900, 900, 32, 6, 6),
    "ragged": (8, 777, 611, 32, 0, 0),
    "d64": (8, 900, 900, 64, 0, 0),
    "d8": (8, 900, 900, 8, 0, 0),  # the micro configuration's head width (floating point only)
}
DCN_SHAPES = {
    # name: (N, Cin, H, W, Cout, stride, deform groups, launches per base frame,
    #        per small frame, groups)
    "base_s3": (6, 256, 58, 100, 256, 1, 1, 23, 0, 1),
    "base_s4": (6, 512, 29, 50, 512, 1, 1, 3, 0, 1),
    "small_s3": (6, 256, 46, 80, 256, 1, 1, 0, 23, 1),
    "small_s4": (6, 512, 23, 40, 512, 1, 1, 0, 3, 1),
    "ragged": (2, 48, 37, 53, 40, 2, 2, 0, 0, 1),
    "groups2": (2, 64, 23, 31, 48, 1, 2, 0, 0, 2),  # two conv groups of 32 -> 24 channels
}
DCN_MODEL_SHAPES = ("base_s3", "base_s4", "small_s3", "small_s4")  # the models' own
# CenterNet-R18's neck at 640 px, a batch of 8 (the same columns; no BEVFormer
# frame launches them): one DCNv2 ahead of each transposed conv
DCN_CENTERNET_SHAPES = {
    "ct_dcn0": (8, 512, 20, 20, 256, 1, 1, 0, 0, 1),
    "ct_dcn1": (8, 256, 40, 40, 128, 1, 1, 0, 0, 1),
    "ct_dcn2": (8, 128, 80, 80, 64, 1, 1, 0, 0, 1),
}
DCN_INT8_SHAPES = {
    # the int8 table is taken only with one deform group, one group and
    # Cin % 32 == 0; same columns as DCN_SHAPES
    **{name: spec for name, spec in DCN_SHAPES.items() if name not in ("ragged", "groups2")},
    "ragged": (2, 96, 37, 53, 40, 2, 1, 0, 0, 1),  # stride 2, ragged size, channel groups of 32
}
MSDA_INT8_SHAPES = {
    # int8 tables: SCA and decoder (TSA's stay floating point by the default policy);
    # name: (shape of MSDA_SHAPES, launches per tiny int8 frame, per base int8 frame)
    "sca": ("sca", 3, 0), "decoder": ("decoder", 6, 0),
    "base4": ("base4", 0, 6), "decoder_base": ("decoder_base", 0, 6),
}
GEMM_SHAPES = {
    # name: (M, K, N): x [M, K] int8, w [N, K] int8
    "dense_decoder": (900, 256, 256),          # every decoder / head projection
    "dense_bev_ffn": (2500, 256, 512),         # tiny encoder FFN fc1
    "dense_bev_base": (40000, 256, 256),       # base encoder projections
    "conv1x1_base_s2": (34800, 256, 1024),     # R101 stage-2 conv3 at base, 6 x 58 x 100
    "conv3x3_k4608": (2250, 4608, 512),        # R50 stage-4 conv2 at tiny, 6 x 15 x 25
    "conv3x3_base_s1": (556800, 576, 64),      # R101 stage-1 conv2 at base, 6 x 232 x 400
    "can_bus_k18": (1, 18, 128),
    "stem_k147": (576000, 147, 64),            # tiny's 7x7 stem, 6 x 240 x 400
    "reference_points_n3": (900, 256, 3),
    # edges of the tile configurations: one row, a narrow N on the narrowest
    # K, K of one 32-byte wgmma step, one row past 132 x 128
    "edge_m1_k4608": (1, 4608, 64),
    "edge_n8_k16": (129, 16, 8),
    "edge_k32": (300, 32, 136),
    "edge_m_tile_plus_1": (16897, 256, 256),
}
PROBE_SHAPES = {
    # the spatial cross-attention gather as tables of 32-channel rows;
    # name: (tables = cameras x heads, keys, queries, taps = levels x points,
    #        width of the largest level, spans of the sweep)
    "sca_base": (48, 30825, 14080, 32, 200, (1, 4, 16, 64, 240)),
    "sca_tiny": (48, 375, 896, 8, 25, (1, 2)),
}
# small stand-ins with the same columns, for a rehearsal on the CPU
TOY_SHAPES = {
    "msda": {"toy": (2, ((6, 7), (3, 4)), 24, 4, 2, 0, 0)},
    "flash": {"toy": (2, 20, 24, 32, 0, 0)},
    "dcn": {"toy": (1, 32, 6, 7, 8, 1, 1, 0, 0, 1)},
    "gemm": {"toy": (24, 32, 8)},
    "probe": {"toy": (2, 256, 16, 8, 16, (1, 2))},
}


def device_ms(fn, n=20, repeats=5):
    """Median over `repeats` of the mean device time of `n` back-to-back
    calls, queued behind a device sleep so the host never starves the card."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / n)
    return float(np.median(out))


def device_kernels(fn, tries=3):
    """Names of the device kernels (and copies) one call of `fn` launches
    (torch.profiler, after a warm-up call), or None if the tracer saw
    nothing.  A device sleep ahead of the call keeps its first launches clear
    of the tracer's start and shows that the tracer was live: a window
    without the sleep's kernel is taken again."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SLEEP_CYCLES // 20)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
    return None


def host_ms(fn, n=2, repeats=2):
    """Host-clock ms of a call on the CPU (a rehearsal, not a device time)."""
    fn()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return float(np.median(out))


def call_ms(fn, device, n: int = 20, repeats: int = 5) -> float:
    """ms a call: `device_ms` on the card, `host_ms` (a rehearsal) on the CPU."""
    if torch.device(device).type == "cuda":
        return device_ms(fn, n=n, repeats=repeats)
    return host_ms(fn, n=max(1, n // 10), repeats=2)


def bound(nbytes, flops, dtype, exps=0):
    """(ms, "bytes" or "operations"): the larger of the least times of the
    bytes, of the products at the peak of `dtype` (a dtype or a key of
    PEAK_FLOPS) and of `exps` exponentials on the special-function units."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


# ---- MSDA -------------------------------------------------------------------

def msda_inputs(spec, dtype, gen, dev, heads=8, ch=32):
    """(value, ref, off, attn), spatial_shapes for a row of MSDA_SHAPES, with
    one offset in twenty well past the borders."""
    bs, shapes, nq, P, ppg = spec[:5]
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = torch.randn(bs, keys, heads, ch, generator=gen)
    ref = torch.rand(bs, nq, 1, 2 * ppg, generator=gen) * 1.2 - 0.1
    off = torch.randn(bs, nq, heads, L * P * 2, generator=gen) * 3
    far = torch.rand(off.shape, generator=gen) < 0.05
    off = torch.where(far, torch.sign(off) * 300.0, off)
    attn = torch.randn(bs, nq, heads, L * P, generator=gen)
    return ([t.to(dev, dtype) for t in (value,)] + [ref.to(dev)]
            + [t.to(dev, dtype) for t in (off, attn)]), shapes


def msda_work(value, ref, off, attn, shapes):
    """(bytes, flops, rows its queries can gather in elements): the value
    counts as the rows this run's queries can gather (one ch-wide row per
    corner) where they are fewer than the table."""
    bs, _, H, ch = value.shape
    nq, L = ref.shape[1], len(shapes)
    P = attn.shape[-1] // L
    esz = value.element_size()
    gathered = min(value.numel(), bs * nq * H * L * P * 4 * ch)
    small = (off.numel() + attn.numel()) * esz + ref.numel() * 4 + bs * nq * H * ch * esz
    return gathered * esz + small, bs * nq * H * L * P * 4 * ch * 2, gathered


def msda_int8_work(value, ref, off, attn, shapes):
    """((wrapper bytes, flops), (kernel-alone bytes, flops)): the wrapper
    reads the whole floating-point value once (its scale is an amax over it);
    the kernel alone reads the int8 rows its queries can gather."""
    bs, _, H, ch = value.shape
    nbytes, flops, gathered = msda_work(value, ref, off, attn, shapes)
    esz = value.element_size()
    small = nbytes - gathered * esz
    return (value.numel() * esz + small, flops), (gathered + bs * H * 4 + small, flops)


def msda_gather_operands(value, ref, off, attn, shapes):
    """What the MSDA kernel gathers, as operands of the gather probes: table
    [bs * heads, keys, ch] (contiguous rows), idx int32 and w float32
    [bs * heads, nq, L * P, 4] with w = softmax weight x bilinear weight x
    border validity, so that `gather_blend(table, idx, w)` is the MSDA output
    [bs, heads, nq, ch]."""
    from ..ops.msda import msda_sampling_locations

    bs, keys, heads, ch = value.shape
    nq, L = ref.shape[1], len(shapes)
    P = attn.shape[-1] // L
    weights = torch.softmax(attn.float(), dim=-1).reshape(bs, nq, heads, L, P)
    loc = msda_sampling_locations(ref.float(), off.float(), shapes, heads)
    idx, w = [], []
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        x = loc[..., lvl, :, 0] * W - 0.5  # [bs, nq, heads, P]
        y = loc[..., lvl, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx1, wy1 = x - x0, y - y0
        ix0 = x0.clamp(-2.0, float(W)).long()
        iy0 = y0.clamp(-2.0, float(H)).long()
        ci, cw = [], []
        for dx, dy, bw in ((0, 0, (1 - wx1) * (1 - wy1)), (1, 0, wx1 * (1 - wy1)),
                           (0, 1, (1 - wx1) * wy1), (1, 1, wx1 * wy1)):
            ix, iy = ix0 + dx, iy0 + dy
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            ci.append(start + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
            cw.append(bw * valid * weights[:, :, :, lvl])
        idx.append(torch.stack(ci, dim=-1))
        w.append(torch.stack(cw, dim=-1))
        start += H * W
    idx = torch.stack(idx, dim=3).permute(0, 2, 1, 3, 4, 5).reshape(bs * heads, nq, L * P, 4)
    w = torch.stack(w, dim=3).permute(0, 2, 1, 3, 4, 5).reshape(bs * heads, nq, L * P, 4)
    table = value.permute(0, 2, 1, 3).reshape(bs * heads, keys, ch).contiguous()
    return table, idx.to(torch.int32).contiguous(), w.float().contiguous()


# ---- flash attention ----------------------------------------------------------

def flash_inputs(spec, dtype, gen, dev):
    B, Lq, Lk, d = spec[:4]
    return tuple(torch.randn(B, n, d, generator=gen).to(dev, dtype) for n in (Lq, Lk, Lk))


def flash_work(q, k, v):
    """(bytes, flops, exponentials) of attention over q [B, Lq, d], k / v
    [B, Lk, d]: q, k, v read and the output written once; 4 flops a (query,
    key, channel); one exponential a (query, key)."""
    B, Lq, d = q.shape
    Lk = k.shape[1]
    return (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), 4 * B * Lq * Lk * d, B * Lq * Lk


def heads_layout(t):
    """[B, L, d] -> [1, L, B * d]: the B problems as the heads of one
    sequence, where `multi_head_attention` reads them (head h = t[h])."""
    B, L, d = t.shape
    return t.transpose(0, 1).reshape(1, L, B * d).contiguous()


def flash_peak(dtype):
    """The peak the floating-point flash kernel's products run at: bfloat16
    on the tensor cores, float32 as split TF32 (three TF32 products)."""
    return "split_tf32" if dtype == torch.float32 else dtype


def flash_int8_work(q, k, v):
    """((wrapper bytes, ops, exponentials), (kernel-alone bytes, ops,
    exponentials)): the kernel alone reads int8 operands with their scales
    and writes the output."""
    nbytes, ops, exps = flash_work(q, k, v)
    alone = q.numel() + k.numel() + v.numel() + 8 + q.numel() * q.element_size()
    return (nbytes, ops, exps), (alone, ops, exps)


# ---- deformable im2col --------------------------------------------------------

def dcn_inputs(spec, dtype, gen, dev, layout="NCHW"):
    """x, offset (one in fifty well past the borders), mask, weight
    [Cout, Cin / groups, 3, 3] and the im2col's geometry keywords for a row
    of DCN_SHAPES, 3x3, padding 1 (the op also takes `groups`, spec[9])."""
    N, Cin, H, W, Cout, stride, dg = spec[:7]
    groups = spec[9]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(N, Cin, H, W, generator=gen)
    off = torch.randn(N, 2 * dg * 9, Ho, Wo, generator=gen) * 2
    far = torch.rand(off.shape, generator=gen) < 0.02
    off = torch.where(far, torch.sign(off) * 300.0, off)
    mask = torch.rand(N, dg * 9, Ho, Wo, generator=gen)
    weight = (torch.randn(Cout, Cin // groups, 3, 3, generator=gen)
              / (Cin // groups * 9) ** 0.5).to(dev)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    x, off, mask = (t.to(dev, dtype) for t in (x, off, mask))
    geo = dict(stride=stride, padding=1, dilation=1, deform_groups=dg, layout=layout)
    return x, off, mask, weight, geo


def dcn_work(spec, esz, x_bytes_per_value=None, scale_bytes=0, taps=9):
    """(bytes, flops, column bytes) of the im2col of a row of DCN_SHAPES with
    `esz`-byte activations: x (by default `esz` bytes a value; 1 for its int8
    table, plus `scale_bytes`), offsets and mask read once, every column
    value written once; 4 corner weights and 4 multiply-adds per value."""
    N, Cin, H, W, _, stride, dg = spec[:7]
    S = ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
    col_bytes = N * taps * Cin * S * esz
    x_bytes = N * Cin * H * W * (esz if x_bytes_per_value is None else x_bytes_per_value)
    nbytes = x_bytes + scale_bytes + N * 3 * dg * taps * S * esz + col_bytes
    return nbytes, 8 * N * taps * Cin * S, col_bytes


def dcn_op_work(spec, esz, scale_bytes=0, taps=9):
    """(bytes, flops) of the whole op at a row of DCN_SHAPES with `esz`-byte
    activations, as the fused kernel does it: x (or, for the int8 table, the
    float map the codes are made from, plus `scale_bytes`), offsets, mask and
    the weight matrix read once, the output written once; 2 flops per
    multiply-add of the product (the sampling's are left out)."""
    N, Cin, H, W, Cout, stride, dg = spec[:7]
    groups = spec[9]
    S = ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
    nbytes = (N * Cin * H * W * esz + scale_bytes + N * 3 * dg * taps * S * esz
              + Cout * taps * (Cin // groups) * esz + N * Cout * S * esz)
    return nbytes, 2 * N * Cout * taps * (Cin // groups) * S


# ---- int8 product -------------------------------------------------------------

def gemm_case(M, K, N, gen, dev):
    x = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).to(dev)
    xs = torch.tensor(0.0173, device=dev)
    ws = (torch.rand(N, generator=gen) * 0.02 + 0.001).to(dev)
    return x, w, xs, ws


def gemm_work(M, K, N):
    return M * K + N * K + 4 + 4 * N + 4 * M * N, 2 * M * N * K


def int_mm_takes(M, K, N):
    """Whether `torch._int_mm` (the library's int8 product) takes the shape."""
    return M > 16 and K % 8 == 0 and N % 8 == 0


# ---- gather probes ------------------------------------------------------------

PROBE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def probe_table(B, keys, dtype, gen, dev, ch=32):
    if dtype == torch.int8:
        return torch.randint(-127, 128, (B, keys, ch), generator=gen, dtype=torch.int8).to(dev)
    return torch.randn(B, keys, ch, generator=gen).to(dev, dtype)


def gather_rows_work(table, idx):
    """Rows read (no more than the table holds), 4 bytes of index per row,
    every row written."""
    row = table.shape[2] * table.element_size()
    return min(table.numel() * table.element_size(), idx.numel() * row) + idx.numel() * (4 + row), 0


def gather_blend_work(table, idx):
    """Rows read (no more than the table holds), 8 bytes of index and weight
    per row, one float32 row written per query; 2 flops per gathered value."""
    row = table.shape[2] * table.element_size()
    nbytes = (min(table.numel() * table.element_size(), idx.numel() * row) + idx.numel() * 8
              + idx.shape[0] * idx.shape[1] * table.shape[2] * 4)
    return nbytes, 2 * idx.numel() * table.shape[2]


def gather_blend_library(table, idx, w):
    """The one PyTorch call that computes `gather_blend`, as a yardstick for
    the bench (nothing in the port calls it): `F.embedding_bag` in "sum" mode
    with per-sample weights, over the tables laid end to end as one
    embedding, one bag per (table, query).  Returns a function of no
    arguments whose operands (indices offset to their table, weights in the
    rows' dtype) are made here, ahead of any timing, and which returns
    [B, nq, ch] in the rows' dtype; None for int8 rows, which
    `embedding_bag` does not take."""
    if not table.dtype.is_floating_point:
        return None
    B, keys, ch = table.shape
    nq = idx.shape[1]
    rows = table.reshape(B * keys, ch)
    first = torch.arange(B, device=idx.device, dtype=idx.dtype) * keys
    bags = (idx.clamp(0, keys - 1) + first[:, None, None, None]).reshape(B * nq, -1)
    weights = w.reshape(B * nq, -1).to(table.dtype)

    def call():
        out = torch.nn.functional.embedding_bag(bags, rows, per_sample_weights=weights,
                                                mode="sum")
        return out.reshape(B, nq, ch)

    return call


# ---- gradients: every kernel op through its autograd Function --------------

# op: (the wrapper whose launch count the op moves, the table of its shapes)
GRAD_OPS = {
    "msda": ("multi_scale_deformable_attn", "msda"),
    "msda_int8": ("multi_scale_deformable_attn_int8", "msda"),
    "flash": ("flash_attention", "flash"),
    "flash_int8": ("flash_attention_int8", "flash"),
    "dcn_im2col": ("deform_im2col", "dcn"),            # float32 maps: the im2col route
    "dcn_fused": ("modulated_deform_conv2d", "dcn"),   # bfloat16 maps: the fused kernel
    "dcn_fused_int8": ("modulated_deform_conv2d_int8", "dcn"),  # the int8 table
}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # relative, per input's gradient


def grad_case(op, spec, gen, dev):
    """(kernel, plain, inputs, dtype) for one op of GRAD_OPS at a row of
    MSDA_SHAPES, FLASH_SHAPES or DCN_SHAPES: `kernel(*inputs)` is the call the
    model makes (flash: the heads read where they lie, [1, L, B * d]), and
    `plain(*inputs)` the function whose autograd the Function's backward
    must equal: the floating-point plain version, in float32 for the fused
    DCN kernel, and straight through for the int8 ones."""
    from ..ops import attention as attn_ops
    from ..ops import dcn as dcn_ops
    from ..ops import msda as msda_ops

    if GRAD_OPS[op][1] == "msda":
        inputs, shapes = msda_inputs(spec, torch.float32, gen, dev)
        wrapper = (msda_ops.multi_scale_deformable_attn_int8 if op == "msda_int8"
                   else msda_ops.multi_scale_deformable_attn)
        return (lambda *t: wrapper(*t, shapes),
                lambda *t: msda_ops.multi_scale_deformable_attn_plain(*t, shapes),
                inputs, torch.float32)
    if GRAD_OPS[op][1] == "flash":
        B = spec[0]
        inputs = [heads_layout(t) for t in flash_inputs(spec, torch.float32, gen, dev)]
        return (lambda q, k, v: attn_ops.multi_head_attention(q, k, v, B, int8=op == "flash_int8"),
                lambda q, k, v: attn_ops.qkv_heads_plain(q, k, v, B), inputs, torch.float32)
    dtype = torch.bfloat16 if op == "dcn_fused" else torch.float32
    x, off, mask, weight, geo = dcn_inputs(spec, dtype, gen, dev)
    quant = "int8" if op == "dcn_fused_int8" else False
    kw = dict(geo, groups=spec[9])

    def plain(x, off, mask, weight):
        return dcn_ops.modulated_deform_conv2d_plain(x.float(), off.float(), mask.float(),
                                                     weight, None, **kw).to(x.dtype)

    return (lambda x, off, mask, weight: dcn_ops.modulated_deform_conv2d(
                x, off, mask, weight, None, quant=quant, **kw),
            plain, [x, off, mask, weight], dtype)


def grad_check(kernel, plain, inputs, gen):
    """Gradients of <kernel(*inputs), cot> through the kernel's autograd
    Function against those of <plain(*inputs), cot>, with one seeded
    cotangent, every floating-point input requiring grad.  Returns the
    kernel's output and each input's relative gradient error (max |a - b| /
    max |b|); raises where the kernel's output has no grad_fn or a gradient
    is missing or not finite."""
    def run(fn):
        ins = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
        out = fn(*ins)
        return out, ins

    out, ins = run(kernel)
    if out.grad_fn is None:
        raise AssertionError("the kernel's output has no grad_fn")
    cot = torch.randn(out.shape, generator=gen).to(out.device, out.dtype)
    got = torch.autograd.grad(out, ins, cot)
    ref, ref_ins = run(plain)
    want = torch.autograd.grad(ref, ref_ins, cot)
    errs = []
    for g, w in zip(got, want):
        if g is None or not torch.isfinite(g).all():
            raise AssertionError("a gradient is missing or not finite")
        errs.append(float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)))
    return out, errs
