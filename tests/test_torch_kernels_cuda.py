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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,d", [(900, 900, 32), (77, 611, 32), (130, 65, 64), (33, 40, 8)])
def test_flash_kernel_matches_plain(cuda, dtype, Lq, Lk, d):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, n, d, generator=g).to(cuda, dtype) for n in (Lq, Lk, Lk))
    before = attn_ops.flash_attention.launches
    got = attn_ops.flash_attention(q, k, v)
    want = attn_ops.qkv_plain(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 1
    assert rel(got, want) < TOL[dtype]


def dcn_case(N, Cin, H, W, Cout, stride, dg, dtype, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(N, Cin, H, W, generator=g).to(dev, dtype)
    off = torch.randn(N, 2 * dg * 9, Ho, Wo, generator=g) * 2
    far = torch.rand(off.shape, generator=g) < 0.03  # well past the borders
    off = torch.where(far, torch.sign(off) * 200.0, off).to(dev, dtype)
    mask = torch.rand(N, dg * 9, Ho, Wo, generator=g).to(dev, dtype)
    weight = (torch.randn(Cout, Cin, 3, 3, generator=g) / (Cin * 9) ** 0.5).to(dev)
    bias = torch.randn(Cout, generator=g).to(dev)
    return x, off, mask, weight, bias


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
    before = dcn_ops.modulated_deform_conv2d.launches
    col = dcn_ops.deform_im2col(x, off, mask, (3, 3), **kw)
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=1, **kw)
    torch.cuda.synchronize()
    assert dcn_ops.modulated_deform_conv2d.launches == before + 2
    want_col = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **kw)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, groups=1, **kw)
    assert col.dtype == dtype and col.shape == want_col.shape
    assert rel(col, want_col) < TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < TOL[dtype]


def test_dcn_kernel_dilation_and_edges(cuda):
    """Dilation 2 with two deform groups, and samples exactly on the
    validity edges (-1, H - 1, H) of a 1x1 kernel."""
    x, off, mask, weight, bias = dcn_case(2, 16, 11, 13, 8, 1, 2, torch.float32, cuda)
    kw = dict(stride=1, padding=2, dilation=2, deform_groups=2)
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, **kw)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, bias, **kw)
    assert rel(got, want) < TOL[torch.float32]
    H, W = 5, 6
    x = torch.randn(1, 3, H, W, device=cuda)
    edges = torch.tensor([-1.0, -0.999, 0.0, H - 1.0, H - 1 + 1e-3, H, 1e9, -1e9, 3e38])
    off = torch.zeros(1, 2, H, W, device=cuda)
    off[0, 0].view(-1)[:len(edges)] = edges.to(cuda) - torch.arange(len(edges), device=cuda) // W
    ones = torch.ones(1, 1, H, W, device=cuda)
    w1 = torch.ones(1, 3, 1, 1, device=cuda)
    got = dcn_ops.modulated_deform_conv2d(x, off, ones, w1, None, padding=0)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, ones, w1, None, padding=0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() < 1e-5
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
    before = (dcn_ops.deform_im2col_int8.launches, dcn_ops.modulated_deform_conv2d.launches)
    q, scale = dcn_ops.quantize_dcn_table(x, chg, layout)
    col = dcn_ops.deform_im2col_int8(q, scale, off, mask, (3, 3), **kw)
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, groups=1, quant="int8", **kw)
    torch.cuda.synchronize()
    assert (dcn_ops.deform_im2col_int8.launches,
            dcn_ops.modulated_deform_conv2d.launches) == (before[0] + 2, before[1])
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
    assert dcn_ops.modulated_deform_conv2d.launches == before[1] + 1


def test_dcn_int8_takes_the_float_table_where_it_is_not_eligible(cuda):
    """Two deform groups or a width that 32 does not divide: `quant` is
    ignored, the floating-point kernel runs, bit for bit the same result."""
    for Cin, dg in ((48, 1), (64, 2)):
        x, off, mask, weight, bias = dcn_case(2, Cin, 9, 11, 8, 1, dg, torch.float32, cuda)
        kw = dict(stride=1, padding=1, dilation=1, deform_groups=dg)
        before = (dcn_ops.deform_im2col_int8.launches, dcn_ops.modulated_deform_conv2d.launches)
        got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, bias, quant="int8", **kw)
        assert (dcn_ops.deform_im2col_int8.launches,
                dcn_ops.modulated_deform_conv2d.launches) == (before[0], before[1] + 1)
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
    same = msda_ops.multi_scale_deformable_attn_int8(value, ref, off, attn, shapes, table=table)
    want = msda_ops.multi_scale_deformable_attn_int8_plain(value, ref, off, attn, shapes)
    torch.cuda.synchronize()
    assert (msda_ops.multi_scale_deformable_attn_int8.launches,
            msda_ops.multi_scale_deformable_attn.launches) == (before[0] + 2, before[1])
    assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, same)
    assert rel(got, want) < TOL[dtype]
    full = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes)
    assert 1e-4 < rel(got, full) < 5e-2  # the int8 table is in use


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,d", [(900, 900, 32), (77, 611, 32), (130, 256, 64), (33, 40, 64)])
def test_flash_int8_kernel_matches_plain(cuda, dtype, Lq, Lk, d):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, n, d, generator=g).to(cuda, dtype) for n in (Lq, Lk, Lk))
    before = attn_ops.flash_attention_int8.launches
    got = attn_ops.flash_attention_int8(q, k, v)
    want = attn_ops.flash_attention_int8_plain(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention_int8.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) < (1e-4 if dtype == torch.float32 else 1e-2)
    assert 1e-4 < rel(got, attn_ops.qkv_plain(q, k, v)) < 0.15  # not the float function


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
    with pytest.raises(NotImplementedError, match="groups"):
        dcn_ops.modulated_deform_conv2d(x, off, mask, weight[:, :4].contiguous(), groups=2)
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
        msda_ops.multi_scale_deformable_attn_int8(
            value, ref, off, attn, ((6, 7),),
            table=(value.to(torch.int8), torch.ones(1, 3, device=cuda)))
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [*per_frame] + [0] * 7
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [E, 0, 0, len(calls), E + D, D, 0, 0, 0]
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
    launches 26 DCN im2cols and agrees with the plain path."""
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [
        2 * cfg.encoder_layers + cfg.decoder_layers, cfg.decoder_layers, 26, 0, 0, 0, 0, 0, 0]
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    with plain_versions():
        engine.reset()
        plain_classes, plain_coords = engine.infer_frame(image, torch.zeros(18), l2i, "scene")
    assert rel(classes, plain_classes) < 1e-4 and rel(coords, plain_coords) < 1e-4


def test_micro_r101_dcn_int8_engine_runs_through_the_int8_table_kernel(cuda):
    """The same backbone under the default int8 policy (head width 32, so the
    int8 value tables and int8 flash run too): 26 int8-table im2cols and no
    floating-point one per frame; with `dcn_tables` excluded the other way
    round."""
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
    assert counts[:3] == [E, 0, 0] and counts[4:] == [E + D, D, 26, 0, 0] and counts[3] > 100
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    other = BEVFormerEngine(bevformer_micro(
        quant="int8", quant_exclude=("self_attn/msda_tables", "dcn_tables"), **over), seed=0)
    attach_quant_scales(other.model, scales)
    ops.reset_launch_counts()
    other_classes, other_coords = other.infer_frame(**frames[0])
    torch.cuda.synchronize()
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [E, 0, 26, counts[3], E + D, D, 0, 0, 0]
    drift = float((coords - other_coords).abs().mean())
    assert 0 < drift < 0.3  # the table is in use; its noise moves the boxes a little
