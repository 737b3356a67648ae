"""BEVDet on the card: the int8 frame with the int8 product kernel against
the plain product, the float32 frame against the CPU's, and the splat's two
formulations against a float64 splat.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_bevdet_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevdet import BEVDet
from bevformer_tensorrt_tpu_torch.models.necks.view_transformer import (
    get_lidar_coor,
    voxel_pooling_prepare,
)
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.ops.bev_pool import bev_pool_v2
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.runtime.bevdet_engine import BEVDetEngine
from bevformer_tensorrt_tpu_torch.runtime.synthetic import bevdet_rig
from bevformer_tensorrt_tpu_torch.weights import init_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ranks(cfg, intervals=True):
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, np.random.default_rng(0))
    return voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=600,
                                 pad_intervals_to=cfg.bev_h * cfg.bev_w if intervals else None)


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w)).astype(np.float32)
            for _ in range(n)]


def _state_dict(cfg):
    model = init_weights(BEVDet(cfg), torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_int8_frame_kernel_equals_plain_product(cuda):
    """Micro BEVDet under int8 on the card: one int8 product launch per
    convolution, and the heads bit for bit those of the same frame with the
    plain product swapped in."""
    cfg = bevdet_micro()
    ranks = _ranks(cfg)
    sd = _state_dict(cfg)
    qdq = BEVDetEngine(bevdet_micro(quant=True), ranks, state_dict=sd, device=cuda)
    scales = qdq.calibrate(_images(cfg, 2), method="max").scales
    engine = BEVDetEngine(bevdet_micro(quant="int8"), ranks, state_dict=sd, device=cuda)
    attach_quant_scales(engine.model, scales)
    image = _images(cfg, 1, seed=1)[0]
    int8_ops.int8_matmul.launches = 0
    got = engine.heads(image)
    torch.cuda.synchronize()
    layers = sum(getattr(m, "mode", None) == "int8" for m in engine.model.modules())
    assert int8_ops.int8_matmul.launches == layers == 89
    kernel = int8_ops.int8_matmul
    int8_ops.int8_matmul = int8_ops.int8_matmul_plain
    try:
        want = engine.heads(image)
    finally:
        int8_ops.int8_matmul = kernel
    for k in got:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k


def test_float32_frame_matches_the_cpu(cuda):
    """Micro BEVDet in float32 on the card against the CPU: each head within
    1e-4 of its max (cuDNN's summation order against the CPU's)."""
    cfg = bevdet_micro()
    ranks = _ranks(cfg)
    sd = _state_dict(cfg)
    image = _images(cfg, 1)[0]
    got = BEVDetEngine(cfg, ranks, state_dict=sd, device=cuda).heads(image)
    want = BEVDetEngine(cfg, ranks, state_dict=sd, device="cpu").heads(image)
    for k in want:
        err = (got[k].cpu() - want[k]).abs().max() / want[k].abs().max()
        assert err <= 1e-4, (k, float(err))


@pytest.mark.parametrize("impl", ["interval", "scatter"])
def test_bev_pool_matches_float64_on_the_card(impl, cuda):
    """Both splats at R50's frustum size (6 x 59 x 16 x 44 points, 64
    channels, 128x128 cells, pads of rank -1 past 250000 points) against a
    float64 scatter on the card, relative to the result's max: `scatter`
    within 1e-6 (a cell's ~15 float32 adds), `interval` within 5e-5 (the
    difference of two float32 prefix sums over up to 250000 points: 8.9e-6
    on the CPU for these inputs)."""
    rng = np.random.default_rng(2)
    N, D, H, W, C, cells, P = 6, 59, 16, 44, 64, 128 * 128, 260000
    n = 250000
    rb = np.sort(rng.integers(0, cells, n))
    ranks_bev = np.full(P, -1, np.int64)
    ranks_bev[:n] = rb
    ranks_depth = np.full(P, -1, np.int64)
    ranks_depth[:n] = rng.integers(0, N * D * H * W, n)
    ranks_feat = np.full(P, -1, np.int64)
    ranks_feat[:n] = rng.integers(0, N * H * W, n)
    first = np.ones(n, bool)
    first[1:] = rb[1:] != rb[:-1]
    starts = np.zeros(cells, np.int64)
    lens = np.zeros(cells, np.int64)
    s = np.flatnonzero(first)
    starts[:len(s)] = s
    lens[:len(s)] = np.diff(np.append(s, n))
    depth = torch.softmax(torch.from_numpy(rng.standard_normal((N, D, H, W)).astype(np.float32)),
                          1).to(cuda)
    feat = torch.from_numpy(rng.standard_normal((N, H, W, C)).astype(np.float32)).to(cuda)
    r = [torch.from_numpy(a).to(cuda) for a in (ranks_depth, ranks_feat, ranks_bev, starts, lens)]
    kw = dict(out_height=128, out_width=128)
    ref = bev_pool_v2(depth.double(), feat.double(), *r[:3], **kw)
    got = bev_pool_v2(depth, feat, *r, impl=impl, **kw) if impl == "interval" else \
        bev_pool_v2(depth, feat, *r[:3], **kw)
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert torch.isfinite(got).all() and err <= (5e-5 if impl == "interval" else 1e-6), err
