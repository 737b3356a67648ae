"""BEVDet's parts in the port against the JAX package on the CPU: the host
geometry's ranks (bit for bit), the BEV pool in both formulations (with
pads), the aligned-corner upsampling, the BEV encoder, neck and head
modules, the CenterPoint decode, Scale-NMS with the native rotated NMS
against the numpy one (the same kept indices), and the checkpoint importer.
The whole micro detector against the JAX package is in
tests/test_torch_bevdet_model.py."""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs.bevdet import bevdet_micro as jax_micro
from bevformer_tensorrt_tpu.configs.bevdet import bevdet_r50 as jax_r50
from bevformer_tensorrt_tpu.core.nms import nms_rotated as jax_nms_rotated
from bevformer_tensorrt_tpu.core.nms import scale_nms as jax_scale_nms
from bevformer_tensorrt_tpu.models.backbones import bev_resnet as jax_bev_resnet
from bevformer_tensorrt_tpu.models.detectors.bevdet import CustomFPN as JaxCustomFPN
from bevformer_tensorrt_tpu.models.heads import centerpoint_head as jax_head
from bevformer_tensorrt_tpu.models.necks import view_transformer as jax_vt
from bevformer_tensorrt_tpu.ops.bev_pool import bev_pool_v2 as jax_bev_pool
from bevformer_tensorrt_tpu.runtime.torch_import import import_bevdet_checkpoint
from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro, bevdet_r50
from bevformer_tensorrt_tpu_torch.core.nms import nms_rotated, rotated_iou_bev, scale_nms
from bevformer_tensorrt_tpu_torch.models.backbones.bev_resnet import (
    FPN_LSS,
    BasicBlock,
    CustomResNet,
    upsample_bilinear,
)
from bevformer_tensorrt_tpu_torch.models.detectors.bevdet import BEVDet, CustomFPN
from bevformer_tensorrt_tpu_torch.models.heads.centerpoint_head import (
    CenterHead,
    centerpoint_decode,
    centerpoint_post_process,
)
from bevformer_tensorrt_tpu_torch.models.necks import view_transformer as vt
from bevformer_tensorrt_tpu_torch.native import nms_rotated_native, rotated_iou_matrix_native
from bevformer_tensorrt_tpu_torch.ops.bev_pool import bev_pool_v2
from bevformer_tensorrt_tpu_torch.runtime.synthetic import bevdet_rig
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    bevdet_upstream_layout,
    load_bevdet_checkpoint,
)
from bevformer_tensorrt_tpu_torch.weights import init_weights, params_from_jax
from test_torch_import import synthetic_bevdet_state_dict
from torch_port_helpers import load_port, random_variables, rel, run_pair_nchw

torch.set_num_threads(2)

RANK_FIELDS = ("ranks_depth", "ranks_feat", "ranks_bev", "interval_starts", "interval_lengths")


def _coor(cfg, seed=0):
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, np.random.default_rng(seed))
    return s2e, intr


@pytest.mark.parametrize("name", ["micro", "r50"])
def test_ranks_equal_jax_bit_for_bit(name):
    """The frustum, the lidar coordinates and the sorted, padded ranks of
    a surround rig (with an image-augmentation and a BEV rotation too) are
    the JAX package's, bit for bit."""
    cfg, jcfg = (bevdet_micro(), jax_micro()) if name == "micro" else (bevdet_r50(), jax_r50())
    s2e, intr = _coor(cfg)
    np.testing.assert_array_equal(vt.make_frustum(cfg), jax_vt.make_frustum(jcfg))
    rng = np.random.default_rng(1)
    a = 0.1
    post_rot = np.broadcast_to(np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                                         [0, 0, 1]], np.float32), (cfg.num_cams, 3, 3)).copy()
    post_tran = rng.normal(0, 2, (cfg.num_cams, 3)).astype(np.float32)
    bda = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    for extra in ({}, dict(post_rot=post_rot, post_tran=post_tran, bda=bda)):
        coor = vt.get_lidar_coor(cfg, s2e, intr, **extra)
        np.testing.assert_array_equal(coor, jax_vt.get_lidar_coor(jcfg, s2e, intr, **extra))
        n = len(vt.voxel_pooling_prepare(cfg, coor).ranks_bev)
        assert n > 100
        for pads in (dict(), dict(pad_to=n + 1000, pad_intervals_to=cfg.bev_h * cfg.bev_w)):
            got = vt.voxel_pooling_prepare(cfg, coor, **pads)
            want = jax_vt.voxel_pooling_prepare(jcfg, coor, **pads)
            for f in RANK_FIELDS:
                g, w = getattr(got, f), getattr(want, f)
                assert g.dtype == w.dtype and np.array_equal(g, w), (name, f)
    with pytest.raises(ValueError, match="pad_to"):
        vt.voxel_pooling_prepare(cfg, coor, pad_to=n - 1)


def _pool_case(seed=0, N=2, D=8, H=4, W=8, C=16, cells=(16, 16), pad=300):
    """A splat with every BEV cell hit a random number of times, the ranks
    sorted by cell, and `pad` pads of rank -1 whose depth and feature
    indices are -1 too (a -1 index read would pick the last element, made
    huge here)."""
    rng = np.random.default_rng(seed)
    depth = rng.random((N, D, H, W)).astype(np.float32)
    feat = rng.standard_normal((N, H, W, C)).astype(np.float32)
    depth.reshape(-1)[-1] = 1e6
    feat.reshape(-1, C)[-1] = 1e6
    P = 700
    rb = np.sort(rng.integers(0, cells[0] * cells[1], P)).astype(np.int32)
    rd = rng.integers(0, N * D * H * W - 1, P).astype(np.int32)
    rf = rng.integers(0, N * H * W - 1, P).astype(np.int32)
    first = np.ones(P, bool)
    first[1:] = rb[1:] != rb[:-1]
    s = np.flatnonzero(first).astype(np.int32)
    starts = np.zeros(cells[0] * cells[1], np.int32)
    lens = np.zeros(cells[0] * cells[1], np.int32)
    starts[:len(s)] = s
    lens[:len(s)] = np.diff(np.append(s, P))
    m1 = np.full(pad, -1, np.int32)
    return (depth, feat, np.concatenate([rd, m1]), np.concatenate([rf, m1]),
            np.concatenate([rb, m1]), starts, lens)


@pytest.mark.parametrize("impl", ["scatter", "interval"])
def test_bev_pool_matches_jax(impl):
    """Both formulations with pads against the JAX package's both
    formulations, within 1e-5 of the result's max; the pads add nothing."""
    depth, feat, rd, rf, rb, starts, lens = _pool_case()
    kw = dict(out_height=16, out_width=16)
    t = [torch.from_numpy(a) for a in (depth, feat, rd, rf, rb, starts, lens)]
    iv = t[5:] if impl == "interval" else (None, None)
    got = bev_pool_v2(*t[:5], *iv, impl=impl, **kw).numpy()
    for jimpl in ("scatter", "interval"):
        want = np.asarray(jax_bev_pool(depth, feat, rd, rf, rb, starts, lens, impl=jimpl, **kw))
        assert got.shape == want.shape == (1, 16, 16, 16)
        assert rel(got, want) < 1e-5, jimpl
    valid = rb >= 0
    ref = np.zeros((256, 16))
    np.add.at(ref, rb[valid], depth.reshape(-1)[rd[valid]][:, None].astype(np.float64)
              * feat.reshape(-1, 16)[rf[valid]])
    assert rel(got.reshape(256, 16), ref) < 1e-5
    assert np.abs(got).max() < 1e3  # no pad read the huge last element


def test_bev_pool_bfloat16_features_and_bad_impl():
    depth, feat, rd, rf, rb, starts, lens = _pool_case(seed=1)
    t = [torch.from_numpy(a) for a in (depth, feat, rd, rf, rb, starts, lens)]
    f32 = bev_pool_v2(*t[:5], *t[5:], impl="interval", out_height=16, out_width=16)
    bf = bev_pool_v2(t[0], t[1].bfloat16(), *t[2:5], *t[5:], impl="interval", out_height=16,
                     out_width=16)
    assert bf.dtype == torch.bfloat16 and rel(bf.float().numpy(), f32.numpy()) < 1e-2
    with pytest.raises(ValueError, match="impl"):
        bev_pool_v2(*t[:5], impl="sorted")
    with pytest.raises(ValueError, match="interval_starts"):
        bev_pool_v2(*t[:5], impl="interval")


@pytest.mark.parametrize("shape,scale", [((1, 5, 4, 6), 4), ((2, 3, 7, 3), 2), ((1, 2, 1, 5), 2)])
def test_upsample_bilinear_matches_jax(shape, scale):
    """Aligned-corner bilinear upsampling against the JAX module's explicit
    corner grid (NHWC there), within 1e-6; the half-pixel form differs."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_bev_resnet.upsample_bilinear(x.transpose(0, 2, 3, 1), scale))
    got = upsample_bilinear(torch.from_numpy(x), scale).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape and rel(got, want) < 1e-6
    if shape[2] > 1:
        half = torch.nn.functional.interpolate(torch.from_numpy(x), scale_factor=scale,
                                               mode="bilinear", align_corners=False)
        assert rel(half.numpy().transpose(0, 2, 3, 1), want) > 1e-3


def test_bev_encoder_modules_match_jax(rng):
    """BasicBlock (with and without its downsample conv), CustomResNet,
    FPN_LSS and CustomFPN against the JAX modules, within 1e-5."""
    x = rng.standard_normal((1, 8, 16, 16)).astype(np.float32)
    for jm, pm in ((jax_bev_resnet.BasicBlock(planes=12, stride=2), BasicBlock(8, 12, 2)),
                   (jax_bev_resnet.BasicBlock(planes=8, stride=1), BasicBlock(8, 8, 1))):
        want, got = run_pair_nchw(jm, pm, rng, x)
        assert rel(got[0], want[0]) < 1e-5
    want, got = run_pair_nchw(jax_bev_resnet.CustomResNet(num_channels=(8, 16, 32)),
                              CustomResNet(8, (8, 16, 32)), rng, x)
    assert len(got) == 3 and all(rel(g, w) < 1e-5 for g, w in zip(got, want))
    feats = [rng.standard_normal((1, c, 16 // 2 ** i, 16 // 2 ** i)).astype(np.float32)
             for i, c in enumerate((8, 16, 32))]
    want, got = _list_pair(jax_bev_resnet.FPN_LSS(out_channels=12), FPN_LSS(8 + 32, 12), rng,
                           feats)
    assert got.shape == (1, 12, 32, 32) and rel(got, want) < 1e-5
    ins = [rng.standard_normal((2, c, s, t)).astype(np.float32)
           for c, s, t in ((16, 6, 11), (24, 3, 6))]
    want, got = _list_pair(JaxCustomFPN(out_channels=8), CustomFPN((16, 24), 8), rng, ins)
    assert got.shape == (2, 8, 6, 11) and rel(got, want) < 1e-5


class _ListArgs(fnn.Module):
    """Calls a flax module that takes a list of maps with positional maps."""

    inner: fnn.Module

    @fnn.compact
    def __call__(self, *xs):
        return self.inner(list(xs))


def _list_pair(jax_module, port_module, rng, maps):
    """(JAX output, port output), both NCHW, of a module taking a list of
    maps, with one set of seeded weights."""
    nhwc = [np.ascontiguousarray(m.transpose(0, 2, 3, 1)) for m in maps]
    wrapper = _ListArgs(jax_module)
    variables = random_variables(wrapper, rng, *nhwc)
    want = np.asarray(wrapper.apply(variables, *nhwc)).transpose(0, 3, 1, 2)
    load_port(port_module, {col: tree["inner"] for col, tree in variables.items()})
    with torch.no_grad():
        got = port_module([torch.from_numpy(m) for m in maps]).numpy()
    return want, got


def test_center_head_matches_jax(rng):
    cfg = bevdet_micro()
    x = rng.standard_normal((1, 24, 16, 16)).astype(np.float32)
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    head = jax_head.CenterHead(jax_micro())
    variables = random_variables(head, rng, nhwc)
    want = head.apply(variables, nhwc)
    port = load_port(CenterHead(cfg, 24), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k].numpy().transpose(0, 2, 3, 1), np.asarray(want[k])) < 1e-5, k


def _heads(cfg, rng, ties=False):
    H, W = cfg.bev_h, cfg.bev_w
    heads = {k: (rng.standard_normal((1, H, W, c)) * s).astype(np.float32) for k, c, s in (
        ("reg", 2, 0.3), ("height", 1, 1.0), ("dim", 3, 0.5), ("rot", 2, 1.0), ("vel", 2, 1.0),
        ("heatmap", cfg.num_classes, 1.0))}
    heads["heatmap"] -= 4.5  # some of the top scores under the threshold
    if ties:  # equal scores across cells and classes
        heads["heatmap"] = np.round(heads["heatmap"], 1)
    return heads


@pytest.mark.parametrize("ties", [False, True])
def test_centerpoint_decode_matches_jax(ties, rng):
    """The decode of NCHW maps against the JAX decode of the same NHWC
    maps: the same class-major top-k order (ties too: the lower flat index
    first), labels and validity, boxes within 1e-6."""
    cfg = bevdet_micro(max_num=64)
    heads = _heads(cfg, rng, ties)
    jb, js, jl, jv = jax_head.centerpoint_decode(jax_micro(max_num=64),
                                                 {k: jnp.asarray(v) for k, v in heads.items()})
    b, s, lab, v = centerpoint_decode(cfg, {k: torch.from_numpy(x.transpose(0, 3, 1, 2))
                                            for k, x in heads.items()})
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    assert 0 < v.sum() < len(v)


def _boxes9(rng, n, spread=12.0):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.3, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.normal(size=(n, 2))
    return b


@pytest.mark.parametrize("seed", range(4))
def test_scale_nms_native_keeps_the_numpy_indices(seed):
    """Scale-NMS through the native rotated NMS against the numpy NMS of the
    JAX package (and the port's copy of it): the same kept indices, in the
    same order, over 200 crowded boxes of every class."""
    rng = np.random.default_rng(seed)
    cfg = bevdet_r50()
    b = _boxes9(rng, 200)
    s = rng.random(200).astype(np.float32)
    lab = rng.integers(0, 10, 200)
    want = jax_scale_nms(b, s, lab, cfg.nms_thr, cfg.nms_rescale_factor)
    got = scale_nms(b, s, lab, cfg.nms_thr, cfg.nms_rescale_factor, nms=nms_rotated_native)
    assert 10 < len(want) < 200
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        scale_nms(b, s, lab, cfg.nms_thr, cfg.nms_rescale_factor), want)
    b5 = b[:, [0, 1, 3, 4, 6]]
    np.testing.assert_array_equal(nms_rotated_native(b5, s, 0.2), jax_nms_rotated(b5, s, 0.2))
    assert len(nms_rotated_native(np.zeros((0, 5), np.float32), np.zeros(0), 0.2)) == 0


def test_rotated_iou_matrix_native_matches_numpy(rng):
    b5 = _boxes9(rng, 30, spread=3.0)[:, [0, 1, 3, 4, 6]]
    got = rotated_iou_matrix_native(b5[:12], b5)
    want = np.array([[rotated_iou_bev(x, y) for y in b5] for x in b5[:12]])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got > 0.01).sum() > 12
    with pytest.raises(ValueError, match="5"):
        nms_rotated_native(np.zeros((3, 4), np.float32), np.zeros(3), 0.2)


def test_post_process_keeps_the_valid_boxes_after_scale_nms(rng):
    cfg = bevdet_micro(max_num=64)
    heads = _heads(cfg, rng)
    out = centerpoint_decode(cfg, {k: torch.from_numpy(x.transpose(0, 3, 1, 2))
                                   for k, x in heads.items()})
    det = centerpoint_post_process(cfg, *(t.numpy() for t in out))
    want = jax_head.centerpoint_post_process(jax_micro(max_num=64),
                                             {k: jnp.asarray(v) for k, v in heads.items()})
    for k in ("boxes_3d", "scores_3d", "labels_3d"):
        np.testing.assert_allclose(det[k], want[k], rtol=1e-6, atol=1e-6)
    assert 0 < len(det["boxes_3d"]) <= int(out[3].sum())
    raw = centerpoint_post_process(cfg, *(t.numpy() for t in out), nms=False)
    assert len(raw["boxes_3d"]) == int(out[3].sum())


@pytest.mark.parametrize("name", ["micro", "r50"])
def test_bevdet_checkpoint_import_matches_jax(name):
    """The upstream-layout state_dict of tests/test_torch_import.py through
    `load_bevdet_checkpoint` equals the JAX importer's tree carried across by
    `params_from_jax`, tensor for tensor; `bevdet_upstream_layout` inverts
    it; a missing or unknown key raises."""
    cfg = bevdet_micro() if name == "micro" else bevdet_r50()
    sd = synthetic_bevdet_state_dict(cfg, np.random.default_rng(0))
    sd["img_backbone.bn1.num_batches_tracked"] = np.array(0)
    got = load_bevdet_checkpoint(cfg, sd)
    want = params_from_jax(import_bevdet_checkpoint(sd, depth=cfg.backbone_depth))
    assert sorted(got) == sorted(want) == sorted(BEVDet(cfg).state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = bevdet_upstream_layout(cfg, got)
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in back)
    with pytest.raises(KeyError, match="img_neck.fpn_convs.0.conv.bias"):
        load_bevdet_checkpoint(cfg, {k: v for k, v in sd.items()
                                     if k != "img_neck.fpn_convs.0.conv.bias"})
    with pytest.raises(KeyError, match="takes no key 'extra.weight'"):
        load_bevdet_checkpoint(cfg, {**sd, "extra.weight": np.zeros(1)})
    with pytest.raises(TypeError):
        load_bevdet_checkpoint(object(), sd)


def test_seeded_bevdet_init():
    """The seeded init fills every tensor of BEVDet-R50 deterministically,
    the heatmap conv's bias with the CenterPoint prior."""
    a = init_weights(BEVDet(bevdet_micro()), torch.Generator().manual_seed(0))
    b = init_weights(BEVDet(bevdet_micro()), torch.Generator().manual_seed(0))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.all(a.pts_bbox_head.heatmap.conv2.bias == -2.19)
    assert torch.all(a.pts_bbox_head.reg.conv2.bias == 0)
    with pytest.raises(ValueError, match="quant"):
        BEVDet(bevdet_micro(quant="int4"))
