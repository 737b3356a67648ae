"""The PyTorch port's BEVFormer modules against the JAX package's (CPU, float32).

Each flax module gets seeded numpy weights, which reach the port module
through `params_from_jax`; both see the same numpy inputs and must agree to
a relative error of 1e-5 (the DCN backbone, many layers deep, 1e-4).  The
flax backbone and neck are NHWC and the port's are NCHW: the same numpy image
reaches each in its own layout and the outputs are compared as NCHW.
"""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs.bevformer import bevformer_micro as jax_micro
from bevformer_tensorrt_tpu.models.backbones import resnet as jax_resnet
from bevformer_tensorrt_tpu.models.heads.bevformer_head import RegBranch as JaxRegBranch
from bevformer_tensorrt_tpu.models.modules import attention as jax_attn
from bevformer_tensorrt_tpu.models.modules.decoder import (
    DetectionTransformerDecoder as JaxDecoder,
)
from bevformer_tensorrt_tpu.models.modules.encoder import (
    get_reference_points_3d,
    point_sampling as jax_point_sampling,
)
from bevformer_tensorrt_tpu.models.modules.transformer import (
    can_bus_to_shift as jax_can_bus_to_shift,
)
from bevformer_tensorrt_tpu.models.necks.fpn import FPN as JaxFPN
from bevformer_tensorrt_tpu.ops import rotate as jax_rotate
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.backbones import resnet as port_resnet
from bevformer_tensorrt_tpu_torch.models.heads.bevformer_head import RegBranch
from bevformer_tensorrt_tpu_torch.models.modules import attention as port_attn
from bevformer_tensorrt_tpu_torch.models.modules.decoder import DetectionTransformerDecoder
from bevformer_tensorrt_tpu_torch.models.modules.encoder import point_sampling
from bevformer_tensorrt_tpu_torch.models.modules.transformer import can_bus_to_shift
from bevformer_tensorrt_tpu_torch.models.necks.fpn import FPN
from bevformer_tensorrt_tpu_torch.ops import rotate
from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig
from torch_port_helpers import load_port, random_variables, rel, run_pair_nchw

torch.set_num_threads(2)

TOL = 1e-5
C, HEADS = 64, 4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_pair(jax_module, port_module, rng, *args):
    """Apply both modules to numpy `args` (None passes through) with one set
    of seeded weights; returns (jax_out, port_out) as numpy."""
    variables = random_variables(jax_module, rng, *args)
    want = jax_module.apply(variables, *args)
    load_port(port_module, variables)
    with torch.no_grad():
        got = port_module(*(t(a) if isinstance(a, np.ndarray) else a for a in args))
    return np.asarray(want), got.numpy()


def test_temporal_self_attention(rng):
    bh, bw = 6, 7
    nq = bh * bw
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((2, nq, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    ref = rng.uniform(-0.05, 1.05, (2, nq, 1, 2)).astype(np.float32)
    want, got = run_pair(
        jax_attn.TemporalSelfAttention(embed_dims=C, num_heads=HEADS, num_points=4,
                                       msda_impl="jnp"),
        port_attn.TemporalSelfAttention(C, HEADS, 1, 4),
        rng, query, value, query, pos, ref, ((bh, bw),))
    assert rel(got, want) < TOL


@pytest.mark.parametrize("compact", [False, True])
def test_spatial_cross_attention(compact, rng):
    """compact=True: nq 300 > K 128 with the visibility weights tied across
    the K boundary (0.5 covers ranks ~100-200 of every camera), so the
    top-K tie rule decides which queries each camera keeps."""
    cams, ppg, shapes = 3, 4, ((6, 8), (3, 4))
    nq = 300 if compact else 40
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((cams, keys, C)).astype(np.float32)
    ref_cam = rng.uniform(-0.1, 1.1, (cams, nq, ppg * 2)).astype(np.float32)
    mask = rng.choice([0.0, 0.5, 1.0], (cams, nq, 1), p=[0.34, 0.33, 0.33]).astype(np.float32)
    if compact:
        assert ((mask[..., 0] > 0).sum(1) > 128).all()
    want, got = run_pair(
        jax_attn.SpatialCrossAttention(embed_dims=C, num_cams=cams, num_heads=HEADS,
                                       num_levels=L, num_points=8, cam_budget=0.35,
                                       msda_impl="jnp"),
        port_attn.SpatialCrossAttention(C, cams, HEADS, L, 8, 0.35),
        rng, query, value, query, None, ref_cam, mask, shapes)
    assert rel(got, want) < TOL


def test_compaction_tie_keeps_lower_index():
    mask = torch.tensor([[0.5, 1.0, 0.5, 0.5, 0.0, 0.5]]).reshape(1, 6, 1)
    ref = torch.rand(1, 6, 2)
    topi, topv, ref_c = port_attn.camera_compaction(mask, ref, 3)
    assert topi.tolist() == [[1, 0, 2]]
    topi, topv, ref_c = port_attn.camera_compaction(torch.zeros(1, 6, 1), ref, 2)
    assert topi.tolist() == [[0, 1]] and (ref_c == 2.0).all()


def test_decoder_cross_attention(rng):
    bh, bw, nq = 8, 9, 30
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((1, bh * bw, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    ref = rng.uniform(-0.05, 1.05, (1, nq, 1, 2)).astype(np.float32)
    want, got = run_pair(
        jax_attn.CustomMSDeformableAttention(embed_dims=C, num_heads=HEADS, num_points=4,
                                             msda_impl="jnp"),
        port_attn.CustomMSDeformableAttention(C, HEADS, 1, 4),
        rng, query, value, query, pos, ref, ((bh, bw),))
    assert rel(got, want) < TOL


def test_decoder_self_attention(rng):
    nq = 45
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    want, got = run_pair(
        jax_attn.MultiheadAttention(embed_dims=C, num_heads=2),
        port_attn.MultiheadAttention(C, 2),
        rng, query, query, query, query, pos, pos)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("angle", [0.0, 7.3, -123.4])
def test_rotate(angle, rng):
    img = rng.standard_normal((5, 20, 24)).astype(np.float32)
    center = np.array([10.0, 9.0], np.float32)
    want = jax_rotate(img, jnp.float32(angle), center, interpolation="nearest")
    got = rotate(t(img), torch.tensor(angle), (10.0, 9.0), interpolation="nearest")
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("dx,dy", [(1.3, 0.4), (-0.7, 0.9), (-0.2, -1.5), (0.0, 0.0)])
def test_can_bus_to_shift(dx, dy, rng):
    can_bus = rng.standard_normal(18).astype(np.float32)
    can_bus[0], can_bus[1] = dx, dy
    want = np.asarray(jax_can_bus_to_shift(jnp.asarray(can_bus), (2.048, 2.048), 50, 50, True))
    got = can_bus_to_shift(t(can_bus), (2.048, 2.048), 50, 50, True).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)


def test_point_sampling(rng):
    cfg = bevformer_micro(num_cams=4, bev_h=10, bev_w=12)
    ref_3d = get_reference_points_3d(cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar)
    l2i = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    want = jax_point_sampling(jnp.asarray(ref_3d), cfg.pc_range, jnp.asarray(l2i),
                              (cfg.img_h, cfg.img_w), cfg.num_cams)
    got = point_sampling(t(ref_3d), cfg.pc_range, t(l2i), (cfg.img_h, cfg.img_w), cfg.num_cams)
    assert 0 < float(got[1].sum()) < cfg.bev_h * cfg.bev_w  # some but not all visible
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < TOL


class JaxDecoderWithBranches(fnn.Module):
    cfg: object

    @fnn.compact
    def __call__(self, query, query_pos, value, reference_points):
        regs = [JaxRegBranch(self.cfg, name=f"reg_branch{i}")
                for i in range(self.cfg.decoder_layers)]
        return JaxDecoder(self.cfg, name="decoder")(
            query, query_pos, value, reference_points, lambda lid, x: regs[lid](x))


class DecoderWithBranches(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        for i in range(cfg.decoder_layers):
            setattr(self, f"reg_branch{i}", RegBranch(cfg))
        self.decoder = DetectionTransformerDecoder(cfg)

    def forward(self, query, query_pos, value, reference_points):
        return self.decoder(query, query_pos, value, reference_points,
                            lambda lid, x: getattr(self, f"reg_branch{lid}")(x))


def test_decoder(rng):
    jcfg, cfg = jax_micro(msda_impl="jnp"), bevformer_micro()
    nq, Cm = cfg.num_query, cfg.embed_dims
    query = rng.standard_normal((1, nq, Cm)).astype(np.float32)
    pos = rng.standard_normal((1, nq, Cm)).astype(np.float32)
    value = rng.standard_normal((1, cfg.bev_h * cfg.bev_w, Cm)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (1, nq, 3)).astype(np.float32)
    jm = JaxDecoderWithBranches(jcfg)
    variables = random_variables(jm, rng, query, pos, value, ref)
    want = jm.apply(variables, query, pos, value, ref)
    pm = load_port(DecoderWithBranches(cfg), variables)
    with torch.no_grad():
        got = pm(t(query), t(pos), t(value), t(ref))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), w) < TOL


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv2d(stride, rng):
    x = rng.standard_normal((2, 16, 9, 12)).astype(np.float32)
    want, got = run_pair_nchw(
        jax_resnet.DeformConv2d(features=24, strides=(stride, stride)),
        port_resnet.DeformConv2d(16, 24, stride), rng, x)
    assert got[0].shape == want[0].shape == (2, 24, (9 - 1) // stride + 1, (12 - 1) // stride + 1)
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("style,dcn,stride", [
    ("caffe", True, 2), ("caffe", True, 1), ("caffe", False, 2), ("pytorch", True, 2)])
def test_bottleneck_styles(style, dcn, stride, rng):
    """caffe puts the stride on the first 1x1, so its DCN runs at stride 1;
    pytorch style gives the DCN (and its conv_offset) the stride."""
    x = rng.standard_normal((2, 32, 10, 13)).astype(np.float32)
    want, got = run_pair_nchw(
        jax_resnet.Bottleneck(planes=8, strides=(stride, stride), downsample=True, style=style,
                              dcn=dcn),
        port_resnet.Bottleneck(32, 8, stride, True, style, dcn), rng, x)
    assert rel(got[0], want[0]) < TOL


def test_backbone_r50_caffe_dcn(rng):
    """R50, caffe style, DCN on stages 3-4, three outputs, as base's R101
    is configured (the R101 itself is in test_torch_r101.py)."""
    x = rng.standard_normal((1, 3, 64, 96)).astype(np.float32)
    kw = dict(depth=50, out_indices=(1, 2, 3), dcn_stages=(False, False, True, True),
              style="caffe")
    want, got = run_pair_nchw(jax_resnet.ResNet(**kw), port_resnet.ResNet(**kw), rng, x)
    assert [g.shape[1:] for g in got] == [(512, 8, 12), (1024, 4, 6), (2048, 2, 3)]
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-4


class JaxFPN4(fnn.Module):
    @fnn.compact
    def __call__(self, c3, c4, c5):
        return JaxFPN(out_channels=16, num_outs=4, name="fpn")([c3, c4, c5])


class FPN4(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fpn = FPN([8, 16, 32], 16, 4)

    def forward(self, c3, c4, c5):
        return self.fpn([c3, c4, c5])


def test_fpn_three_in_four_out_odd(rng):
    """Base's neck: three inputs, four outputs; the sizes follow base's
    116x200 -> 58x100 -> 29x50 -> 15x25 in kind: odd laterals (17 rows
    over 9 over 5) crop the upsampled maps, and the extra stride-2 conv takes
    an odd step (5 -> 3, as base's 29 -> 15)."""
    c3 = rng.standard_normal((2, 8, 17, 20)).astype(np.float32)
    c4 = rng.standard_normal((2, 16, 9, 10)).astype(np.float32)
    c5 = rng.standard_normal((2, 32, 5, 5)).astype(np.float32)
    want, got = run_pair_nchw(JaxFPN4(), FPN4(), rng, c3, c4, c5)
    assert [g.shape for g in got] == [(2, 16, 17, 20), (2, 16, 9, 10), (2, 16, 5, 5),
                                      (2, 16, 3, 3)]
    for g, w in zip(got, want):
        assert rel(g, w) < TOL
