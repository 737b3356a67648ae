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
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == list(per_frame)
    assert torch.isfinite(classes).all() and torch.isfinite(coords).all()
