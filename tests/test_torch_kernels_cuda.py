"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Float32 holds a relative error of 1e-5 (summation order only); bfloat16
outputs may differ by one bfloat16 rounding step (1e-2 relative).
"""
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [*per_frame, 0]
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()


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
        2 * cfg.encoder_layers + cfg.decoder_layers, cfg.decoder_layers, 26]
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
    with plain_versions():
        engine.reset()
        plain_classes, plain_coords = engine.infer_frame(image, torch.zeros(18), l2i, "scene")
    assert rel(classes, plain_classes) < 1e-4 and rel(coords, plain_coords) < 1e-4
