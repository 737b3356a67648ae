"""The PyTorch port's small/base slice against the JAX package (CPU, float32):
the R101 caffe-style backbone with DCNv2 on stages 3-4, and the reduced base
and small models over two frames.

The backbone has its real depth (33 bottlenecks, 26 of them deformable) at a
64x96 image and holds 1e-4 per output.  Reduced base is micro's widths with
R101-DCN, three backbone outputs, four FPN levels and a 20x20 BEV grid, so
the camera compaction is active (K 256 < 400) over four levels; reduced
small is the same with one level from the last stage.  Two frames, the second
temporal, through each package's BEVFormerEngine, hold 1e-4, the bar of
test_full_model_parity.py.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.models.backbones import resnet as jax_resnet
from bevformer_tensorrt_tpu_torch.models.backbones import resnet as port_resnet
from torch_port_helpers import build_engine_case, check_two_frames, rel, run_pair_nchw

torch.set_num_threads(2)

TOL = 1e-4
DCN = (False, False, True, True)
R101 = dict(backbone_depth=101, dcn_stages=DCN, bev_h=20, bev_w=20, rotate_center=(10, 10))
CONFIGS = {
    "base_reduced": dict(R101, backbone_out_indices=(1, 2, 3), num_levels=4),
    "small_reduced": dict(R101, backbone_out_indices=(3,), num_levels=1),
}


def test_backbone_r101_caffe_dcn(rng):
    x = rng.standard_normal((1, 3, 64, 96)).astype(np.float32)
    kw = dict(depth=101, out_indices=(1, 2, 3), dcn_stages=DCN, style="caffe")
    port = port_resnet.ResNet(**kw)
    dcn = [m for m in port.modules() if isinstance(m, port_resnet.DeformConv2d)]
    assert len(dcn) == 26 and all(m.stride == 1 for m in dcn)
    want, got = run_pair_nchw(jax_resnet.ResNet(**kw), port, rng, x)
    assert [g.shape[1:] for g in got] == [(512, 8, 12), (1024, 4, 6), (2048, 2, 3)]
    for g, w in zip(got, want):
        assert rel(g, w) < TOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_frames_match_jax(name):
    case = build_engine_case("bevformer_micro", tuple(CONFIGS[name].items()))
    cfg = case[0]
    assert cfg.backbone_depth == 101 and tuple(cfg.dcn_stages) == DCN
    check_two_frames(case, TOL, name)
