"""The 2D family's new kernel shapes on the card: the int8 product at the
shapes YOLOX and CenterNet give it (the Focus stem's K = 108, padded to the
kernel's K alignment; head convs with N = 1, 4 and 80), and the DCN at
CenterNet-R18's three neck shapes (batch 8, 640 px: float32 maps on the
im2col route, the first block's bfloat16 map on the fused kernel, the int8
table), each against its plain version; then a micro YOLOX and a micro
CenterNet with the DCNv2 neck under int8 on the kernel path against the
plain path.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_2d_cuda.py -m cuda --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
from bevformer_tensorrt_tpu_torch.models.layers import int8_im2col
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.runtime.det2d_engine import Det2DEngine
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc
from bevformer_tensorrt_tpu_torch.tools.path_diff import plain_versions

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # max abs err / max |plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (M, K, N) as the models give them: YOLOX-x's stem (8 x 320 x 320 outputs,
# 3 x 3 x 12 = 108 columns) and its level-0 head outputs (cls 80, reg 4,
# obj 1 over 8 x 80 x 80 points at 320 channels); CenterNet-R18's heads
# (wh and offset 2, heatmap 80 over 8 x 160 x 160 at 64 channels)
GEMM_2D_SHAPES = {"focus_stem": (819200, 108, 80), "cls_out": (51200, 320, 80),
                  "reg_out": (51200, 320, 4), "obj_out": (51200, 320, 1),
                  "ct_wh": (204800, 64, 2), "ct_heatmap": (204800, 64, 80)}


@pytest.mark.parametrize("name", list(GEMM_2D_SHAPES))
def test_int8_product_takes_the_2d_shapes(name, cuda):
    """The int8 product at each shape, K padded as `int8_im2col` pads it,
    bit for bit the plain product."""
    M, K, N = GEMM_2D_SHAPES[name]
    Kp = K + (-K) % int8_ops.K_ALIGN
    gen = torch.Generator().manual_seed(0)
    x, w, xs, ws = kc.gemm_case(M, Kp, N, gen, cuda)
    x[:, K:] = 0
    w[:, K:] = 0
    got = int8_ops.int8_matmul(x, w, xs, ws)
    want = int8_ops.int8_matmul_plain(x, w, xs, ws)
    assert torch.equal(got, want)


def test_focus_stem_columns_pad_to_the_alignment(cuda):
    """The stem's 3x3 im2col over 12 channels has 108 columns: padded with
    zeros to a multiple of K_ALIGN, the product's operand."""
    xq = torch.randint(-127, 128, (2, 12, 32, 32), dtype=torch.int8, device=cuda)
    col, Ho, Wo = int8_im2col(xq, (3, 3), (1, 1), (1, 1), int8_ops.K_ALIGN)
    assert (Ho, Wo) == (32, 32) and col.shape[1] % int8_ops.K_ALIGN == 0
    assert col.shape[1] >= 108 and not col[:, 108:].any()


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", list(kc.DCN_CENTERNET_SHAPES))
def test_dcn_takes_centernet_shapes(name, mode, cuda):
    """The DCN op at CenterNet-R18's neck shapes against its plain version
    (float32: the im2col route; bfloat16: the fused kernel; int8: the fused
    kernel from the int8 table)."""
    dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    x, off, mask, weight, geo = kc.dcn_inputs(kc.DCN_CENTERNET_SHAPES[name], dtype,
                                              torch.Generator().manual_seed(0), cuda)
    quant = "int8" if mode == "int8" else False
    wmat = dcn_ops.dcn_weight_matrix(weight, dtype) if mode != "float32" else None
    got = dcn_ops.modulated_deform_conv2d(x, off, mask, weight, None, quant=quant, wmat=wmat,
                                          **geo)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, weight, None, quant=quant, **geo)
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got).all() and err <= TOL[dtype] * float(want.float().abs().max())


@pytest.mark.parametrize("which", ["yolox", "centernet_dcn"])
def test_micro_int8_kernel_path_against_plain(which, cuda):
    """A micro detector under int8 with scales calibrated on the card: its
    backbone bit for bit the plain path's (the int8 product is exact); YOLOX
    all the way, CenterNet (DCNv2 neck) within rms 0.15 past the DCN."""
    cfg = yolox_micro() if which == "yolox" else centernet_micro(use_dcn=True)
    images = np.random.default_rng(0).standard_normal((4, 3, 64, 64)).astype(np.float32)
    # the same seed gives the QDQ and the int8 tier the same weights
    qdq = Det2DEngine(dataclasses.replace(cfg, quant=True), device=cuda)
    result = qdq.calibrate([images], method="max")
    engine = Det2DEngine(dataclasses.replace(cfg, quant="int8"), device=cuda)
    attach_quant_scales(engine.model, result.scales)
    kept = []
    hook = engine.model.backbone.register_forward_hook(lambda m, i, o: kept.append(o))
    with torch.inference_mode():
        got = engine.heads(images)
        with plain_versions():
            want = engine.heads(images)
    hook.remove()
    assert all(torch.equal(a, b) for a, b in zip(kept[0], kept[1]))
    if which == "yolox":
        assert all(torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in g)
    else:
        for k in want:
            rms = float((got[k] - want[k]).float().norm() / want[k].float().norm())
            assert rms < 0.15, (k, rms)
