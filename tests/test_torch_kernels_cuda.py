"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Float32 holds a relative error of 1e-5 (summation order only); bfloat16
outputs may differ by one bfloat16 rounding step (1e-2 relative).  The int8
product is exact, so its float32 output equals the plain version's bit for
bit; the int8 flash kernel may flip a `round(p * 127)` where `expf` differs
from `torch.exp` in the last bit (1e-4).  The int8-table im2col holds the
floating-point kernel's bars against its plain version (the same table on
both sides); the row gather is exact and the blend sums float32 in another
order (1e-5).
"""
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import gather_probe as probe_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def msda_case(shapes, bs, nq, heads, ch, P, ppg, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = torch.randn(bs, keys, heads, ch, generator=g).to(dev, dtype)
    ref = (torch.rand(bs, nq, 1, 2 * ppg, generator=g) * 1.2 - 0.1).to(dev)
    off = (torch.randn(bs, nq, heads, L * P * 2, generator=g) * 4).to(dev, dtype)
    attn = torch.randn(bs, nq, heads, L * P, generator=g).to(dev, dtype)
    return value, ref, off, attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,P,ppg,ch", [
    (((20, 30),), 4, 1, 32),
    (((15, 25),), 8, 4, 32),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 8, 4, 32),
    (((9, 11),), 4, 1, 8),
    (((9, 11), (5, 6)), 4, 2, 64),
    # edges of the launch geometry: 16 channels, a row of 5 lanes, 48 and 64
    # taps a head (one softmax group across two warps)
    (((30, 40), (15, 20)), 4, 2, 16),
    (((9, 11),), 4, 1, 20),
    (((9, 11), (5, 6), (3, 3)), 16, 4, 32),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 16, 4, 32),
])
def test_msda_kernel_matches_plain(cuda, dtype, shapes, P, ppg, ch):
    args = msda_case(shapes, 3, 257, 4, ch, P, ppg, dtype, cuda)
    before = msda_ops.multi_scale_deformable_attn.launches
    got = msda_ops.multi_scale_deformable_attn(*args, shapes)
    want = msda_ops.multi_scale_deformable_attn_plain(*args, shapes)
    torch.cuda.synchronize()
    assert msda_ops.multi_scale_deformable_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,P,ppg,ch,heads", [
    (((20, 25), (10, 13), (5, 7), (3, 4)), 80, 4, 32, 8),   # 320 taps a head: two passes
    (((9, 11), (5, 6)), 4, 2, 256, 4),                     # ch 256: two chunks of 128
    (((9, 11), (5, 6)), 4, 2, 200, 4),                     # a narrower last chunk
    (((16, 20), (8, 10), (4, 5), (2, 3)), 64, 4, 32, 64),  # 64 heads x 256 taps: 4 passes
    (((9, 11),), 300, 4, 64, 2),                           # 300 taps of one level
])
def test_msda_passes_and_chunks_match_plain(cuda, dtype, shapes, P, ppg, ch, heads, int8):
    """Problems one block cannot take in one pass or one chunk: the softmax's
    stats over all the taps first, then passes into one float32 sum; rows
    past 128 channels on a grid axis.  Both tables."""
    args = msda_case(shapes, 2, 97, heads, ch, P, ppg, dtype, cuda, seed=4)
    op = msda_ops.multi_scale_deformable_attn_int8 if int8 else msda_ops.multi_scale_deformable_attn
    plain = (msda_ops.multi_scale_deformable_attn_int8_plain if int8
             else msda_ops.multi_scale_deformable_attn_plain)
    geo = msda_ops.msda_launch_geometry(2, 97, heads, ch, len(shapes), P, 1 if int8 else 4)
    assert geo["passes"] > 1 or geo["chunks"] > 1
    before = op.launches
    got = op(*args, shapes)
    want = plain(*args, shapes)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


def attention_case(B, Lq, Lk, E, dtype, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, n, E, generator=g).to(dev, dtype) for n in (Lq, Lk, Lk))


def split_heads(x, heads):
    B, L, E = x.shape
    return x.reshape(B, L, heads, E // heads).transpose(1, 2).reshape(B * heads, L, E // heads)


def merge_heads(x, B):
    BH, L, d = x.shape
    return x.reshape(B, BH // B, L, d).transpose(1, 2).reshape(B, L, BH // B * d)


@pytest.mark.parametrize("layout", ["bld", "heads"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,d", [(900, 900, 32), (77, 611, 32), (130, 65, 64), (33, 40, 8)])
def test_flash_kernel_matches_plain(cuda, dtype, Lq, Lk, d, layout):
    """[B, L, d] through `flash_attention`, and [B, L, heads * d] through
    `multi_head_attention`, which reads the heads where they lie."""
    heads = 1 if layout == "bld" else 3
    q, k, v = attention_case(4 if heads == 1 else 2, Lq, Lk, heads * d, dtype, cuda)
    before = attn_ops.flash_attention.launches
    if heads == 1:
        got = attn_ops.flash_attention(q, k, v)
        want = attn_ops.qkv_plain(q, k, v)
    else:
        got = attn_ops.multi_head_attention(q, k, v, num_heads=heads)
        want = merge_heads(attn_ops.qkv_plain(*(split_heads(t, heads) for t in (q, k, v))), 2)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


def dcn_case(N, Cin, H, W, Cout, stride, dg, dtype, dev, seed=3, groups=1):
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(N, Cin, H, W, generator=g).to(dev, dtype)
    off = torch.randn(N, 2 * dg * 9, Ho, Wo, generator=g) * 2
    far = torch.rand(off.shape, generator=g) < 0.03  # well past the borders
    off = torch.where(far, torch.sign(off) * 200.0, off).to(dev, dtype)
    mask = torch.rand(N, dg * 9, Ho, Wo, generator=g).to(dev, dtype)
    weight = (torch.randn(Cout, Cin // groups, 3, 3, generator=g) / (Cin * 9) ** 0.5).to(dev)
    bias = torch.randn(Cout, generator=g).to(dev)
    return x, off, mask, weight, bias


def dcn_counts():
    """(float op, its im2col, int8-table op, gather table, int8 im2col) launches."""
    return (dcn_ops.modulated_deform_conv2d.launches, dcn_ops.deform_im2col.launches,
            dcn_ops.modulated_deform_conv2d_int8.launches, dcn_ops.dcn_gather_table.launches,
            dcn_ops.deform_im2col_int8.launches)


def float_op_counts(dtype, layout):
    """What one floating-point DCN op launches: float32 the im2col route;
    bfloat16 the fused kernel, after the gather table where the map is NCHW."""
    if dtype == torch.float32:
        return (0, 1, 0, 0, 0)
    return (1, 0, 0, int(layout == "NCHW"), 0)


def step(before, *adds):
    out = list(before)
    for add in adds:
        out = [a + b for a, b in zip(out, add)]
    return tuple(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("N,Cin,H,W,Cout,stride,dg", [
    (2, 64, 29, 50, 64, 1, 1),
    (3, 48, 37, 53, 40, 2, 2),
    (1, 7, 5, 3, 9, 1, 1),
    (2, 40, 16, 130, 24, 1, 4),
])
def test_dcn_kernel_matches_plain(cuda, dtype, layout, N, Cin, H, W, Cout, stride, dg):
    x, off, mask, weight, bias = dcn_case(N, Cin, H, W, Cout, stride, dg, dtype, cuda)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    kw = dict(stride=stride, padding=1, dilation=1, deform_groups=dg, layout=layout)
    before = dcn_counts()
    col = dcn_ops.deform_im2col(x, off, mask, (3, 3), **kw)
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=1, **kw)
    torch.cuda.synchronize()
    assert dcn_counts() == step(before, (0, 1, 0, 0, 0), float_op_counts(dtype, layout))
    want_col = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **kw)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, groups=1, **kw)
    assert col.dtype == dtype and col.shape == want_col.shape
    assert rel(col, want_col) < TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("N,Cin,H,W,Cout,stride,dg,groups", [
    (2, 64, 23, 31, 48, 1, 2, 2),
    (2, 64, 23, 31, 48, 1, 1, 2),
    (1, 96, 17, 19, 36, 2, 2, 3),
    (1, 32, 9, 13, 512, 1, 1, 2),   # groups of 256 outputs: the 256-row tile
])
def test_dcn_groups_match_plain(cuda, dtype, layout, N, Cin, H, W, Cout, stride, dg, groups):
    """`groups` on the card (it used to be refused): against the plain op."""
    x, off, mask, weight, bias = dcn_case(N, Cin, H, W, Cout, stride, dg, dtype, cuda,
                                          groups=groups)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    kw = dict(stride=stride, padding=1, dilation=1, deform_groups=dg, layout=layout)
    before = dcn_counts()
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=groups, **kw)
    torch.cuda.synchronize()
    assert dcn_counts() == step(before, float_op_counts(dtype, layout))
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, groups=groups, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


FUSED_CASES = [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)]


@pytest.mark.parametrize("dtype,int8", FUSED_CASES)
@pytest.mark.parametrize("name", ["base_s3", "base_s4", "small_s3", "small_s4"])
def test_fused_dcn_at_the_model_shapes(cuda, dtype, name, int8):
    """The fused kernel (bfloat16 map; int8 table in both dtypes; float32
    maps take the im2col route) at the shapes of base and small, offsets
    past every border, the kept weight matrix."""
    from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc
    spec = kc.DCN_SHAPES[name]
    x, off, mask, weight, geo = kc.dcn_inputs(spec, dtype, torch.Generator().manual_seed(7), cuda)
    wmat = dcn_ops.dcn_weight_matrix(weight, dtype)
    quant = "int8" if int8 else False
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, quant=quant, wmat=wmat,
                                          **geo)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, None, quant=quant, **geo)
    torch.cuda.synchronize()
    assert rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype,int8", FUSED_CASES)
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fused_dcn_copy_weight(cuda, dtype, layout, int8):
    """A 0/1 weight that copies one (tap, channel) into each output: a wrong
    swizzle or K order shows as a permutation, not as noise."""
    N, Cin, H, W, Cout = 2, 128, 12, 17, 256
    x, off, mask, _, _ = dcn_case(N, Cin, H, W, Cout, 1, 1, dtype, cuda, seed=8)
    w = torch.zeros(Cout, Cin, 3, 3)
    for o in range(Cout):
        w[o, (o * 7) % Cin, o % 3, (o // 3) % 3] = 1.0
    w = w.to(cuda)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    quant = "int8" if int8 else False
    kw = dict(layout=layout, quant=quant)
    for config in [c for c, v in dcn_ops.DCN_CONFIGS.items() if v[0] == dtype]:
        got, launch = dcn_ops.fused_launcher(x, off, mask, w, None, 1, 1, 1, 1, 1, layout, int8)
        launch(config)
        want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, w, None, **kw)
        torch.cuda.synchronize()
        # one sample a output: only its rounding to the activation dtype differs
        assert rel(got, want) < (1e-6 if dtype == torch.float32 else 4e-3), config


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_ffma_dcn_shares_tiles_between_blocks(cuda, layout, int8):
    """Float32 activations on the FFMA kernel (the float map, which the op
    sends down the im2col route, through `fused_launcher`), both tile
    configurations, at a shape whose tiles outnumber the blocks an H100
    holds: under the stream-K schedule a tile two blocks split is finished
    by the second from the two float32 shares in the workspace.  Bias on (in
    the head share only): the plain op to 1e-5, the same bits from a second
    launch (head + tail, whichever arrives first), and the arrival counts
    left at zero."""
    x, off, mask, w, b = dcn_case(8, 64, 46, 50, 256, 1, 1, torch.float32, cuda, seed=11)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    quant = "int8" if int8 else False
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, w, b, layout=layout, quant=quant)
    for config in ("f32_128x128", "f32_128x64"):
        got, launch = dcn_ops.fused_launcher(x, off, mask, w, b, 1, 1, 1, 1, 1, layout, int8)
        launch(config)
        first = got.clone()
        launch(config)
        torch.cuda.synchronize()
        assert rel(got, want) < TOL[torch.float32], config
        assert torch.equal(got, first), config
        assert not dcn_ops._stream_k_counts[x.device].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_wgmma_dcn_shares_tiles_between_blocks(cuda, layout, int8):
    """bfloat16 activations on the wgmma kernel, both tile configurations,
    at a shape whose tiles outnumber the blocks an H100 holds: under the
    stream-K schedule a tile two blocks split is finished by the second from
    the two float32 shares in the workspace.  Bias on (in the head share
    only): the plain op to 1e-2, the same bits from a second launch, and the
    arrival counts left at zero."""
    x, off, mask, w, b = dcn_case(8, 64, 46, 50, 256, 1, 1, torch.bfloat16, cuda, seed=12)
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    quant = "int8" if int8 else False
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, w, b, layout=layout, quant=quant)
    for config in ("bf16_256x128", "bf16_128x128"):
        got, launch = dcn_ops.fused_launcher(x, off, mask, w, b, 1, 1, 1, 1, 1, layout, int8)
        launch(config)
        first = got.clone()
        launch(config)
        torch.cuda.synchronize()
        assert rel(got, want) < TOL[torch.bfloat16], config
        assert torch.equal(got, first), config
        assert not dcn_ops._stream_k_counts[x.device].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_gather_table_matches_plain(cuda, dtype, layout):
    """The gather table kernel: the map with its channels last, and the int8
    codes of `quantize_dcn_table` with its scale, bit for bit."""
    x, _, _, _, _ = dcn_case(2, 128, 13, 21, 8, 1, 1, dtype, cuda, seed=9)
    x[:, :32] *= 9.0
    x[:, 96:] = 0.0
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    before = dcn_ops.dcn_gather_table.launches
    for chg in (None, 32, 64):
        got, scale = dcn_ops.dcn_gather_table(x, layout, chg)
        want, want_scale = dcn_ops.dcn_gather_table_plain(x, layout, chg)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (scale is None and want_scale is None) or torch.equal(scale, want_scale)
    # an NHWC float map is its own table: no launch
    assert dcn_ops.dcn_gather_table.launches == before + (2 if layout == "NHWC" else 3)


def test_dcn_kernel_dilation_and_edges(cuda):
    """Dilation 2 with two deform groups, and samples exactly on the
    validity edges (-1, H - 1, H) of a 1x1 kernel, float32 and bfloat16."""
    for dtype in (torch.float32, torch.bfloat16):
        x, off, mask, weight, bias = dcn_case(2, 16, 11, 13, 8, 1, 2, dtype, cuda)
        kw = dict(stride=1, padding=2, dilation=2, deform_groups=2)
        got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, **kw)
        want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, **kw)
        assert rel(got, want) < TOL[dtype]
    H, W = 5, 6
    x = torch.randn(1, 3, H, W, device=cuda)
    edges = torch.tensor([-1.0, -0.999, 0.0, H - 1.0, H - 1 + 1e-3, H, 1e9, -1e9, 3e38])
    off = torch.zeros(1, 2, H, W, device=cuda)
    off[0, 0].view(-1)[:len(edges)] = edges.to(cuda) - torch.arange(len(edges), device=cuda) // W
    ones = torch.ones(1, 1, H, W, device=cuda)
    w1 = torch.ones(1, 3, 1, 1, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xd, od, md = x.to(dtype), off.to(dtype), ones.to(dtype)
        got = dcn_ops.modulated_deform_conv2d(xd, od, md, w1, None, padding=0)
        want = dcn_ops.modulated_deform_conv2d_plain(xd, od, md, w1, None, padding=0)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() < (1e-5 if dtype == torch.float32
                                                           else 2e-2)
        assert got.view(-1)[0] == 0 and (got.view(-1)[5:9] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("N,Cin,H,W,Cout,stride", [
    (2, 64, 29, 50, 64, 1),
    (3, 96, 37, 53, 40, 2),   # channel groups of 32, stride 2, ragged
    (1, 256, 16, 130, 24, 1),
    (2, 32, 5, 3, 9, 1),
])
def test_dcn_int8_kernel_matches_plain(cuda, dtype, layout, N, Cin, H, W, Cout, stride):
    x, off, mask, weight, bias = dcn_case(N, Cin, H, W, Cout, stride, 1, dtype, cuda)
    chg = dcn_ops.dcn_ch_group(Cin)
    x[:, :chg] *= 5.0  # groups of unlike scale
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    kw = dict(stride=stride, padding=1, dilation=1, deform_groups=1, layout=layout)
    before = dcn_counts()
    q, scale = dcn_ops.quantize_dcn_table(x, chg, layout)
    col = dcn_ops.deform_im2col_int8(q, scale, off, mask, (3, 3), **kw)
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=1, quant="int8", **kw)
    torch.cuda.synchronize()
    # the int8 im2col once (the yardstick, here), the op: its table, then the fused kernel
    assert dcn_counts() == step(before, (0, 0, 1, 1, 1))
    assert q.dtype == torch.int8 and q.shape == x.shape and tuple(scale.shape) == (N, Cin // chg)
    want_col = dcn_ops.deform_im2col_int8_plain(q, scale, off, mask, (3, 3), **kw)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, groups=1,
                                                 quant="int8", **kw)
    assert col.dtype == dtype and col.shape == want_col.shape
    assert rel(col, want_col) < TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]
    full = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=1, **kw)
    assert 1e-4 < rel(got, full) < 5e-2  # the int8 table is in use
    assert dcn_counts() == step(before, (0, 0, 1, 1, 1), float_op_counts(dtype, layout))


def test_dcn_int8_takes_the_float_table_where_it_is_not_eligible(cuda):
    """Two deform groups or a width that 32 does not divide: `quant` is
    ignored, the floating-point op runs, bit for bit the same result."""
    for Cin, dg in ((48, 1), (64, 2)):
        x, off, mask, weight, bias = dcn_case(2, Cin, 9, 11, 8, 1, dg, torch.float32, cuda)
        kw = dict(stride=1, padding=1, dilation=1, deform_groups=dg)
        before = dcn_counts()
        got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, quant="int8", **kw)
        assert dcn_counts() == step(before, float_op_counts(torch.float32, "NCHW"))
        assert torch.equal(got, dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("B,keys,nq,taps,span", [(48, 375, 896, 8, 2), (5, 3000, 128, 32, 4),
                                                 (2, 130, 16, 8, 1), (3, 1000, 33, 5, 0)])
def test_gather_probes_match_plain(cuda, dtype, B, keys, nq, taps, span):
    import numpy as np

    g = torch.Generator().manual_seed(6)
    if span:
        idx, w = probe_ops.make_workload(np.random.default_rng(1), B, nq, taps, keys, span, 25)
        idx, w = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    else:  # no structure, a ragged tap count, and indices past both ends (clamped)
        idx = torch.randint(-5, keys + 5, (B, nq, taps, 4), generator=g, dtype=torch.int32).to(cuda)
        w = torch.randn(B, nq, taps, 4, generator=g).to(cuda)
    if dtype == torch.int8:
        table = torch.randint(-127, 128, (B, keys, 32), generator=g, dtype=torch.int8).to(cuda)
    else:
        table = torch.randn(B, keys, 32, generator=g).to(cuda, dtype)
    before = (probe_ops.gather_rows.launches, probe_ops.gather_blend.launches)
    rows = probe_ops.gather_rows(table, idx.reshape(B, -1))
    blend = probe_ops.gather_blend(table, idx, w)
    torch.cuda.synchronize()
    assert (probe_ops.gather_rows.launches, probe_ops.gather_blend.launches) == (
        before[0] + 1, before[1] + 1)
    assert rows.dtype == dtype and torch.equal(rows, probe_ops.gather_rows_plain(
        table, idx.reshape(B, -1)))
    want = probe_ops.gather_blend_plain(table, idx, w)
    assert blend.dtype == torch.float32 and blend.shape == want.shape
    assert rel(blend, want) < 1e-5


def test_gather_rows_takes_other_row_widths(cuda):
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 77, (3, 500), generator=g, dtype=torch.int32).to(cuda)
    for ch, dtype in ((4, torch.float32), (128, torch.float32), (8, torch.bfloat16),
                      (16, torch.int8), (4, torch.int32)):
        table = torch.randint(-100, 100, (3, 77, ch), generator=g).to(cuda, dtype)
        assert torch.equal(probe_ops.gather_rows(table, idx),
                           probe_ops.gather_rows_plain(table, idx))


BLEND_EDGES = {
    # name: (B, keys, nq, taps, span of make_workload or None for uniform indices, index range)
    "taps1": (3, 500, 77, 1, None, (0, 500)),   # a chunk of 4 entries: ragged row groups
    "taps3": (3, 500, 77, 3, None, (0, 500)),
    "nq1": (4, 300, 1, 8, None, (0, 300)),
    "nq_ragged": (2, 700, 0, 8, None, (0, 700)),  # nq: 3 block tiles and 5 queries
    "one_table": (1, 2000, 500, 32, None, (0, 2000)),  # few outputs: groups share them
    "keys_below_a_window": (2, 50, 100, 8, None, (0, 50)),
    "out_of_range": (3, 1000, 64, 8, None, (-1000, 2000)),  # clamped at both ends
    "span1": (6, 3000, 512, 32, 1, None),
    "span240": (2, 30825, 256, 32, 240, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("case", sorted(BLEND_EDGES))
def test_gather_blend_edges_match_plain(cuda, dtype, case):
    """The blend at the edges of its launch geometry (ragged row groups and
    chunks, one query, a last block tile with few queries, one table, fewer
    keys than a 128-key window, indices past both ends, the sweep's tightest
    and loosest locality) against the plain version, float32 sums in another
    order (1e-5)."""
    import numpy as np

    B, keys, nq, taps, span, lim = BLEND_EDGES[case]
    esz = torch.empty((), dtype=dtype).element_size()
    if nq == 0:
        qt = probe_ops.gather_blend_geometry(B, 1000, 4 * taps, esz)["qt"]
        nq = 3 * qt + 5
        assert nq % probe_ops.gather_blend_geometry(B, nq, 4 * taps, esz)["qt"]
    g = torch.Generator().manual_seed(8)
    if span:
        idx, w = probe_ops.make_workload(np.random.default_rng(2), B, nq, taps, keys, span, 200)
        idx, w = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    else:
        idx = torch.randint(*lim, (B, nq, taps, 4), generator=g, dtype=torch.int32).to(cuda)
        w = torch.randn(B, nq, taps, 4, generator=g).to(cuda)
    if dtype == torch.int8:
        table = torch.randint(-127, 128, (B, keys, 32), generator=g, dtype=torch.int8).to(cuda)
    else:
        table = torch.randn(B, keys, 32, generator=g).to(cuda, dtype)
    before = probe_ops.gather_blend.launches
    got = probe_ops.gather_blend(table, idx, w)
    torch.cuda.synchronize()
    assert probe_ops.gather_blend.launches == before + 1
    want = probe_ops.gather_blend_plain(table, idx, w)
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, nq, 32)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("M,K,N", [
    (900, 256, 256), (2500, 512, 256), (1, 18, 128), (900, 256, 3), (5000, 147, 64),
    (2250, 4608, 512), (129, 16, 65), (34800, 256, 1024), (77, 576, 27),
    # edges of the tile configurations: one row at K 4608, N 8 at K 16, K of
    # one wgmma step, one row past 132 x 128, K 4608 (36 stages) and K 576 on
    # the large tiles
    (1, 4608, 64), (129, 16, 8), (300, 32, 136), (16897, 256, 256), (20000, 4608, 256),
    (40000, 576, 64),
])
def test_int8_gemm_kernel_matches_plain(cuda, M, K, N):
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(cuda)
    if K == 4608:
        x[0], w[0] = 127, 127  # one sum of 7.4e7, past float32's 2^24
    xs = torch.tensor(0.0173, device=cuda)
    ws = (torch.rand(N, generator=g) * 0.02 + 0.001).to(cuda)
    before = int8_ops.int8_matmul.launches
    got = int8_ops.int8_matmul(x, w, xs, ws)
    want = int8_ops.int8_matmul_plain(x, w, xs, ws)
    torch.cuda.synchronize()
    assert int8_ops.int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    got16 = int8_ops.int8_matmul(x, w, xs, ws, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, int8_ops.int8_matmul_plain(x, w, xs, ws, torch.bfloat16))
    if M > 16 and K % 8 == 0 and N % 8 == 0:  # the library's sums are the same integers
        acc = torch._int_mm(x, w.t())
        assert torch.equal(got, acc.float() * (xs * ws)[None, :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,P,ppg,ch,bs,nq", [
    (((15, 25),), 8, 4, 32, 6, 896),
    (((50, 50),), 4, 1, 32, 1, 900),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 8, 4, 32, 3, 257),
    (((9, 11), (5, 6)), 4, 2, 64, 2, 100),
    (((9, 11),), 4, 1, 8, 2, 33),
    (((30, 40), (15, 20)), 4, 2, 16, 2, 300),
    (((9, 11),), 4, 1, 20, 2, 70),
    (((16, 20), (8, 10), (4, 5), (2, 3)), 16, 4, 32, 2, 150),
])
def test_msda_int8_kernel_matches_plain(cuda, dtype, shapes, P, ppg, ch, bs, nq):
    value, ref, off, attn = msda_case(shapes, bs, nq, 4, ch, P, ppg, dtype, cuda)
    value = value * torch.linspace(0.2, 3.0, 4, device=cuda).to(dtype)[None, None, :, None]
    before = (msda_ops.multi_scale_deformable_attn_int8.launches,
              msda_ops.multi_scale_deformable_attn.launches)
    got = msda_ops.multi_scale_deformable_attn_int8(value, ref, off, attn, shapes)
    table = msda_ops.quantize_value_table(value)
    same = msda_ops._msda_cuda(value, ref, off, attn, shapes, int8_table=table)
    want = msda_ops.multi_scale_deformable_attn_int8_plain(value, ref, off, attn, shapes)
    torch.cuda.synchronize()
    assert (msda_ops.multi_scale_deformable_attn_int8.launches,
            msda_ops.multi_scale_deformable_attn.launches) == (before[0] + 2, before[1])
    assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, same)
    assert rel(got, want) < TOL[dtype]
    full = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes)
    assert 1e-4 < rel(got, full) < 5e-2  # the int8 table is in use


@pytest.mark.parametrize("layout", ["bld", "heads"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,d", [(900, 900, 32), (77, 611, 32), (130, 256, 64), (33, 40, 64)])
def test_flash_int8_kernel_matches_plain(cuda, dtype, Lq, Lk, d, layout):
    heads = 1 if layout == "bld" else 3
    q, k, v = attention_case(4 if heads == 1 else 2, Lq, Lk, heads * d, dtype, cuda)
    before = attn_ops.flash_attention_int8.launches
    if heads == 1:
        got = attn_ops.flash_attention_int8(q, k, v)
        want = attn_ops.flash_attention_int8_plain(q, k, v)
        exact = attn_ops.qkv_plain(q, k, v)
    else:
        got = attn_ops.multi_head_attention(q, k, v, num_heads=heads, int8=True)
        split = [split_heads(t, heads) for t in (q, k, v)]
        want = merge_heads(attn_ops.flash_attention_int8_plain(*split), 2)
        exact = merge_heads(attn_ops.qkv_plain(*split), 2)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention_int8.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < (1e-4 if dtype == torch.float32 else 1e-2)
    assert 1e-4 < rel(got, exact) < 0.15  # not the float function


def on_code_boundaries(x):
    """x with one element in eight moved onto a .5 code boundary of its
    tensor's scale (the amax element untouched), where a division that is
    one ulp off rounds the other way."""
    xf = x.float()
    amax = xf.abs().max()
    scale = amax / 127.0
    half = (torch.floor(xf / scale) + 0.5) * scale
    pick = (torch.arange(x.numel(), device=x.device).reshape(x.shape) % 8 == 3) & (xf.abs() < amax)
    return torch.where(pick, half, xf).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,heads,d", [(1, 900, 900, 8, 32), (2, 77, 611, 3, 32),
                                             (4, 130, 256, 1, 64), (1, 33, 40, 2, 64)])
def test_int8_codes_and_scales_match_int8_operands(cuda, dtype, B, Lq, Lk, heads, d):
    """The amax and quantize launches against `int8_operands` of the split
    heads, on the card and on the CPU: codes and scales bit for bit, also
    for values on .5 code boundaries."""
    q, k, v = (on_code_boundaries(t)
               for t in attention_case(B, Lq, Lk, heads * d, dtype, cuda, seed=5))
    for _ in range(3):  # the amax slots alternate between calls
        got = attn_ops.flash_int8_quantize(q, k, v, heads)
    split = [split_heads(t, heads) for t in (q, k, v)]
    plain = attn_ops.int8_operands(*split)
    cpu = attn_ops.int8_operands(*(t.cpu() for t in split))
    torch.cuda.synchronize()
    for a, b, c in zip(got, plain, cpu):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_int8_flash_is_deterministic(cuda):
    q, k, v = attention_case(1, 900, 900, 256, torch.float32, cuda, seed=6)
    a = attn_ops.multi_head_attention(q, k, v, num_heads=8, int8=True)
    b = attn_ops.multi_head_attention(q, k, v, num_heads=8, int8=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_launches_on_the_device(cuda, int8):
    """One decoder self-attention call launches the attention kernel alone
    (floating point) or amax, quantize and attention (int8): no copy splits
    or merges the heads."""
    from bevformer_tensorrt_tpu_torch.tools.kernel_cases import device_kernels

    q, k, v = attention_case(1, 900, 900, 256, torch.float32, cuda, seed=7)
    names = device_kernels(lambda: attn_ops.multi_head_attention(q, k, v, num_heads=8, int8=int8))
    assert names is not None, "the profiler saw no kernel"
    want = ["flash_int8_amax", "flash_int8_quantize", "flash_int8_kernel"] if int8 else [
        "flash_kernel"]
    assert len(names) == len(want) and all(w in n for w, n in zip(want, names)), names


@pytest.mark.parametrize("name,instruction", [("flash_attn", "HMMA"),
                                              ("flash_attn_int8", "IMMA")])
def test_flash_kernels_run_on_the_tensor_cores(cuda, name, instruction):
    """The built library's SASS holds the tensor-core instruction of its
    kernels' products (cuobjdump of the library)."""
    import os
    import subprocess

    from bevformer_tensorrt_tpu_torch.ops import _cuda

    _cuda.load(name)
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           str(_cuda.library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    kernels = [part for part in sass.split("Function : ")[1:]
               if "flash_kernel" in part.splitlines()[0]
               or "flash_int8_kernel" in part.splitlines()[0]]
    assert kernels and all(instruction in part for part in kernels)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    value, ref, off, attn = msda_case(((6, 7),), 1, 10, 2, 32, 4, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        msda_ops.multi_scale_deformable_attn(value, ref, off.transpose(1, 2).contiguous()
                                             .transpose(1, 2), attn, ((6, 7),))
    with pytest.raises(TypeError):
        msda_ops.multi_scale_deformable_attn(value.half(), ref, off.half(), attn.half(),
                                             ((6, 7),))
    with pytest.raises(ValueError, match="spatial_shapes"):
        msda_ops.multi_scale_deformable_attn(value, ref, off, attn, ((6, 8),))
    q = torch.randn(2, 10, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_attention(q, q, q)
    x, off, mask, weight, _ = dcn_case(1, 8, 6, 7, 4, 1, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dcn_ops.modulated_deform_conv2d(x.transpose(2, 3).contiguous().transpose(2, 3), off, mask,
                                        weight)
    with pytest.raises(TypeError):
        dcn_ops.modulated_deform_conv2d(x.half(), off.half(), mask.half(), weight)
    with pytest.raises(ValueError, match="groups"):  # 8 channels in 3 groups
        dcn_ops.modulated_deform_conv2d(x, off, mask, weight[:, :3].contiguous(), groups=3)
    with pytest.raises(ValueError, match="weight matrix"):
        dcn_ops.modulated_deform_conv2d(x.bfloat16(), off.bfloat16(), mask.bfloat16(), weight,
                                        wmat=dcn_ops.dcn_weight_matrix(weight, torch.float32))
    with pytest.raises(TypeError, match="dtype"):
        dcn_ops.modulated_deform_conv2d(x, off.bfloat16(), mask, weight)
    with pytest.raises(ValueError, match="offset"):
        dcn_ops.modulated_deform_conv2d(x, off[:, :16].contiguous(), mask, weight)
    xi = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    ws = torch.ones(4, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        int8_ops.int8_matmul(xi.float(), xi[:4], 1.0, ws)
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        int8_ops.int8_matmul(xi, xi[:4, :16].contiguous(), 1.0, ws)
    with pytest.raises(ValueError, match="w_scale"):
        int8_ops.int8_matmul(xi, xi[:4], 1.0, ws[:3])
    with pytest.raises(TypeError, match="out_dtype"):
        int8_ops.int8_matmul(xi, xi[:4], 1.0, ws, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_attention_int8(q[..., :8].contiguous(), q[..., :8].contiguous(),
                                      q[..., :8].contiguous())
    value, ref, off, attn = msda_case(((6, 7),), 1, 10, 2, 32, 4, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="table"):
        msda_ops._msda_cuda(value, ref, off, attn, ((6, 7),),
                            int8_table=(value.to(torch.int8), torch.ones(1, 3, device=cuda)))
    x, off, mask, weight, _ = dcn_case(1, 64, 6, 7, 4, 1, 1, torch.float32, cuda)
    q, scale = dcn_ops.quantize_dcn_table(x, 64)
    with pytest.raises(TypeError, match="int8"):
        dcn_ops.deform_im2col_int8(x.cuda(), scale, off, mask, (3, 3))
    with pytest.raises(ValueError, match="scale"):
        dcn_ops.deform_im2col_int8(q, scale.repeat(1, 3), off, mask, (3, 3))
    with pytest.raises(ValueError, match="scale"):
        dcn_ops.deform_im2col_int8(q, scale.double(), off, mask, (3, 3))
    with pytest.raises(ValueError, match="contiguous"):
        dcn_ops.deform_im2col_int8(q.transpose(2, 3).contiguous().transpose(2, 3), scale, off,
                                   mask, (3, 3))
    with pytest.raises(ValueError, match="offset"):
        dcn_ops.deform_im2col_int8(q, scale, off[:, :16].contiguous(), mask, (3, 3))
    with pytest.raises(TypeError, match="dtype"):
        dcn_ops.modulated_deform_conv2d(x, off.bfloat16(), mask, weight, quant="int8")
    with pytest.raises(ValueError, match="quant"):
        dcn_ops.modulated_deform_conv2d(x, off, mask, weight, quant="int4")
    table = torch.zeros(2, 20, 32, device=cuda)
    idx = torch.zeros(2, 4, 3, 4, dtype=torch.int32, device=cuda)
    ones = torch.ones(2, 4, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="32 channels"):
        probe_ops.gather_blend(table[..., :16].contiguous(), idx, ones)
    with pytest.raises(TypeError, match="dtype"):
        probe_ops.gather_blend(table.half(), idx, ones)
    with pytest.raises(ValueError, match="contiguous"):
        probe_ops.gather_blend(table, idx.transpose(1, 2).contiguous().transpose(1, 2), ones)
    with pytest.raises(ValueError, match="16-byte"):  # a contiguous view one value in
        probe_ops.gather_blend(torch.zeros(2 * 20 * 32 + 1, device=cuda)[1:].view(2, 20, 32),
                               idx, ones)
    with pytest.raises(ValueError, match="16"):
        probe_ops.gather_rows(table[..., :3].contiguous(), idx.reshape(2, -1))
    with pytest.raises(ValueError, match="one device"):
        probe_ops.gather_rows(table, idx.reshape(2, -1).cpu())


def test_micro_engine_runs_through_the_kernels(cuda):
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine

    cfg = bevformer_micro()
    engine = BEVFormerEngine(cfg, seed=0)
    g = torch.Generator().manual_seed(2)
    image = torch.randn(1, cfg.num_cams, 3, cfg.img_h, cfg.img_w, generator=g)
    l2i = torch.eye(4).repeat(1, cfg.num_cams, 1, 1)
    l2i[..., 0, 0] = l2i[..., 1, 1] = cfg.img_w / 2.0
    ops.reset_launch_counts()
    classes, coords = engine.infer_frame(image, torch.zeros(18), l2i, "scene")
    torch.cuda.synchronize()
    per_frame = (2 * cfg.encoder_layers + cfg.decoder_layers, cfg.decoder_layers)
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [*per_frame] + [0] * 10
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()


def test_micro_int8_engine_runs_through_the_int8_kernels(cuda):
    """Micro with head width 32 under the default int8 policy: calibrate on
    the card, then one frame launches the int8 product for every dense and
    conv layer, int8 tables in SCA and the decoder, floating-point tables in
    TSA, and int8 flash; the plain path gives the same backbone bit for bit
    and outputs within the drift that rounding flips allow."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames
    from bevformer_tensorrt_tpu_torch.tools.path_diff import plain_versions

    import numpy as np

    cfg = bevformer_micro(quant="int8", num_heads=2)
    engine = BEVFormerEngine(cfg, seed=0)
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("a", "a"))
    engine.calibrate(frames, method="max")
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in engine.model.modules() if isinstance(m, (QDense, QConv))]
    ops.reset_launch_counts()
    classes, coords = engine.infer_frame(**frames[0])
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    E, D = cfg.encoder_layers, cfg.decoder_layers
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [E, 0, 0, len(calls), E + D, D] + [0] * 6
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    feats = engine.model.img_backbone(torch.as_tensor(frames[0]["image"][0], device=cuda))
    with plain_versions():
        engine.reset()
        plain_classes, plain_coords = engine.infer_frame(**frames[0])
        plain_feats = engine.model.img_backbone(
            torch.as_tensor(frames[0]["image"][0], device=cuda))
    assert all(torch.equal(a, b) for a, b in zip(feats, plain_feats))
    assert float((coords - plain_coords).abs().mean()) < 0.05


def test_micro_r101_dcn_engine_runs_through_all_three_kernels(cuda):
    """Micro widths with base's backbone and neck: R101 caffe style, DCN on
    stages 3-4, three outputs, four levels.  One frame on the kernel path
    launches 26 DCN im2cols in float32 and agrees with the plain path; the
    backbone in bfloat16 launches 26 fused kernels and 26 gather tables and
    agrees with its plain path in the rms norm."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu_torch.tools.path_diff import plain_versions

    cfg = bevformer_micro(backbone_depth=101, dcn_stages=(False, False, True, True),
                          backbone_out_indices=(1, 2, 3), num_levels=4)
    engine = BEVFormerEngine(cfg, seed=0)
    g = torch.Generator().manual_seed(2)
    image = torch.randn(1, cfg.num_cams, 3, cfg.img_h, cfg.img_w, generator=g)
    l2i = torch.eye(4).repeat(1, cfg.num_cams, 1, 1)
    l2i[..., 0, 0] = l2i[..., 1, 1] = cfg.img_w / 2.0
    ops.reset_launch_counts()
    classes, coords = engine.infer_frame(image, torch.zeros(18), l2i, "scene")
    torch.cuda.synchronize()
    attn = [2 * cfg.encoder_layers + cfg.decoder_layers, cfg.decoder_layers]
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == attn + [0] * 8 + [26, 0]
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    with plain_versions():
        engine.reset()
        plain_classes, plain_coords = engine.infer_frame(image, torch.zeros(18), l2i, "scene")
    assert rel(classes, plain_classes) < 1e-4 and rel(coords, plain_coords) < 1e-4
    # the backbone in bfloat16: the fused kernel and its gather table, no im2col
    backbone = engine.model.img_backbone.to(torch.bfloat16)
    image16 = image[0].to(cuda, torch.bfloat16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        feats = backbone(image16)
    torch.cuda.synchronize()
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0, 0, 26] + [0] * 4 + [26] + [0] * 4
    with plain_versions(), torch.inference_mode():
        plain_feats = backbone(image16)
    for a, b in zip(feats, plain_feats):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 2e-2


def test_micro_r101_dcn_int8_engine_runs_through_the_int8_table_kernel(cuda):
    """The same backbone under the default int8 policy (head width 32, so the
    int8 value tables and int8 flash run too): 26 int8-table DCN ops (the
    gather table, then the fused kernel) and no floating-point one per
    frame; with `dcn_tables` excluded 26 floating-point ones (float32: the
    im2col route) and no int8-table one."""
    import numpy as np

    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames

    over = dict(backbone_depth=101, dcn_stages=(False, False, True, True),
                backbone_out_indices=(1, 2, 3), num_levels=4, num_heads=2)
    cfg = bevformer_micro(quant="int8", **over)
    assert cfg.quant_exclude == ("self_attn/msda_tables",)
    frames = synthetic_frames(cfg, np.random.default_rng(0), ("a", "a"))
    engine = BEVFormerEngine(cfg, seed=0)
    scales = engine.calibrate(frames, method="max").scales
    E, D = cfg.encoder_layers, cfg.decoder_layers
    ops.reset_launch_counts()
    classes, coords = engine.infer_frame(**frames[0])
    torch.cuda.synchronize()
    counts = [fn.launches for fn in ops.KERNEL_WRAPPERS]
    assert counts[:3] == [E, 0, 0] and counts[3] > 100
    assert counts[4:] == [E + D, D, 26, 26, 0, 0, 0, 0]
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    other = BEVFormerEngine(bevformer_micro(
        quant="int8", quant_exclude=("self_attn/msda_tables", "dcn_tables"), **over), seed=0)
    attach_quant_scales(other.model, scales)
    ops.reset_launch_counts()
    other_classes, other_coords = other.infer_frame(**frames[0])
    torch.cuda.synchronize()
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [
        E, 0, 0, counts[3], E + D, D, 0, 0, 0, 0, 26, 0]
    drift = float((coords - other_coords).abs().mean())
    assert 0 < drift < 0.3  # the table is in use; its noise moves the boxes a little
