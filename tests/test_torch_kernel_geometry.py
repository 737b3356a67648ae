"""The Python around the port's int8 product and MSDA kernels, on the CPU:
the rule that picks the product's tile configuration, the TMA tensor-map
arguments and their checks, the MSDA launch geometry, and the int8 weight
matrix that the quantized layers keep.  Every configuration and geometry
must fit in the shared memory of one Hopper block (227 KB) at every shape
of `tools/kernel_cases.py`."""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense, _quantize_input, int8_im2col
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.quant.fold import (
    attach_quant_scales,
    fold_int8_weights,
    int8_weight_matrix,
    quantize_weight,
)
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc

int8_ops = importlib.import_module("bevformer_tensorrt_tpu_torch.ops.int8_matmul")
SMS = 132           # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472    # shared memory of one SM, 1 KB of it reserved per block


@pytest.mark.parametrize("name", sorted(kc.GEMM_SHAPES))
def test_every_product_shape_gets_a_configuration_that_fits(name):
    M, K, N = kc.GEMM_SHAPES[name]
    config = int8_ops.gemm_config(M, N, -(-K // 16) * 16)
    nc, bm, bn, stages = int8_ops.GEMM_CONFIGS[config]
    assert bm == 64 * nc and bn in (64, 128) and stages >= 2
    assert int8_ops.gemm_smem_bytes(config) <= int8_ops.SMEM_LIMIT
    Kp = -(-K // int8_ops.K_ALIGN) * int8_ops.K_ALIGN
    assert int8_ops.tensor_map_args(M, Kp, 0, bm) == ((Kp, M), (Kp,), (128, bm))
    assert int8_ops.tensor_map_args(N, Kp, 4096, bn) == ((Kp, N), (Kp,), (128, bn))
    if M * N >= int8_ops.SMALL_OUTPUTS:  # the large tiles leave no SM without a tile
        assert -(-M // bm) * -(-N // bn) >= SMS


@pytest.mark.parametrize("config", list(int8_ops.GEMM_CONFIGS))
def test_product_configurations_fit_an_sm(config):
    nc, bm, bn, stages = int8_ops.GEMM_CONFIGS[config]
    smem = int8_ops.gemm_smem_bytes(config)
    assert smem == (1024 + stages * (bm + bn) * 128 + nc * 64 * (bn + 8) * 4 + 16 * stages)
    per_sm = 2 if nc == 1 else 1  # the blocks an SM holds, as __launch_bounds__ asks
    assert per_sm * (smem + 1024) <= SM_SMEM
    assert list(int8_ops.GEMM_CONFIGS).index(config) == ["128x128", "128x64", "64x64"].index(config)


def test_product_configuration_rule():
    small = int8_ops.SMALL_OUTPUTS
    assert int8_ops.gemm_config(900, 256, 256) == "64x64"      # decoder dense layers
    assert int8_ops.gemm_config(1, 128, 32) == "64x64"         # can_bus
    assert int8_ops.gemm_config(900, 3, 256) == "64x64"        # reference points
    assert int8_ops.gemm_config(2250, 512, 4608) == "128x128"  # tiny's K 4608 3x3
    assert int8_ops.gemm_config(2250, 512, 1008) == "64x64"
    assert int8_ops.gemm_config(576000, 64, 160) == "128x64"   # the stem
    assert int8_ops.gemm_config(34800, 1024, 256) == "128x128"
    assert int8_ops.gemm_config(small // 256, 256, 256) == "128x128"
    assert int8_ops.gemm_config(small // 256 - 1, 256, 256) == "64x64"
    assert int8_ops.gemm_config(small // 64, 64, 256) == "128x64"
    assert int8_ops.gemm_config(100, 64, 1024) == "128x64"


@pytest.mark.parametrize("rows,K,ptr,box,match", [
    (0, 32, 0, 64, "empty"), (10, 8, 0, 64, "empty"), (10, 24, 0, 64, "16-byte"),
    (10, 32, 8, 64, "16-byte"), (2 ** 31, 32, 0, 64, "int32"), (10, 32, 0, 257, "box"),
    (10, 32, 0, 0, "box"),
])
def test_tensor_map_arguments_refuse_what_tma_does_not_take(rows, K, ptr, box, match):
    with pytest.raises(ValueError, match=match):
        int8_ops.tensor_map_args(rows, K, ptr, box)


def msda_specs():
    specs = {n: (s[0], s[1], s[2], s[3], 32) for n, s in kc.MSDA_SHAPES.items()}
    specs.update({n: (s[0], s[1], s[2], s[3], s[5]) for n, s in kc.MSDA_EDGE_SHAPES.items()})
    return specs


@pytest.mark.parametrize("esz", [4, 2, 1])
@pytest.mark.parametrize("name", sorted(msda_specs()))
def test_msda_geometry_fits_every_shape(name, esz):
    bs, shapes, nq, P, ch = msda_specs()[name]
    L, heads = len(shapes), 8
    geo = msda_ops.msda_launch_geometry(bs, nq, heads, ch, L, P, esz, 0)
    lpp, qt = geo["lpp"], geo["qt"]
    assert L * P <= lpp < 2 * L * P and lpp & (lpp - 1) == 0
    assert geo["threads"] == 256 and geo["threads"] % lpp == 0
    assert 1 <= qt <= nq and (qt * heads * lpp <= msda_ops.MSDA_TAPS_PER_BLOCK or qt == 1)
    assert geo["smem"] == 8 * qt * heads * (4 * lpp + 2) <= msda_ops.SMEM_LIMIT
    assert geo["vw"] == 16 and geo["lanes_per_row"] == ch * esz // 16 <= 32
    assert geo["blocks"] == bs * -(-nq // qt)
    cap = msda_ops.MSDA_TAPS_PER_BLOCK // (heads * lpp)  # spread over blocks where it can
    assert qt == max(1, min(nq, cap, -(-bs * nq // msda_ops.MSDA_MIN_BLOCKS)))
    rpw, seg, warps = geo["rows_per_warp"], geo["seg"], 256 // 32
    assert rpw * geo["lanes_per_row"] <= 32 < 2 * rpw * geo["lanes_per_row"]
    assert seg & (seg - 1) == 0 and 1 <= seg <= rpw
    assert rpw // seg * warps <= qt * heads or seg == rpw  # every warp has an output
    assert seg == 1 or rpw // (seg // 2) * warps > qt * heads  # and no more shares than that


def test_msda_geometry_at_base_cross_attention():
    bs, shapes, nq, P, ppg = kc.MSDA_SHAPES["base4"][:5]
    rows = {}
    for esz in (4, 2, 1):
        geo = msda_ops.msda_launch_geometry(bs, nq, 8, 32, len(shapes), P, esz)
        rows[esz] = (geo["rows_per_warp"], geo["seg"])  # rows a warp instruction reads
        assert (geo["lpp"], geo["qt"], geo["smem"], geo["blocks"]) == (32, 4, 33280, 6 * 3520)
    assert rows == {4: (4, 1), 2: (8, 2), 1: (16, 4)}
    geo = msda_ops.msda_launch_geometry(1, 900, 8, 32, 1, 4, 4)  # the decoder: spread out
    assert (geo["qt"], geo["blocks"], geo["seg"]) == (2, 450, 2)


@pytest.mark.parametrize("ch,esz,ptr,vw", [
    (8, 1, 0, 8), (16, 1, 0, 16), (3, 4, 0, 4), (5, 2, 0, 2), (7, 1, 0, 1), (32, 4, 8, 8),
    (32, 2, 4, 4), (128, 4, 0, 16),
])
def test_msda_geometry_narrows_the_row_loads(ch, esz, ptr, vw):
    geo = msda_ops.msda_launch_geometry(2, 50, 4, ch, 1, 4, esz, ptr)
    assert geo["vw"] == vw and geo["lanes_per_row"] * vw == ch * esz


@pytest.mark.parametrize("heads,ch,L,P,match", [
    (8, 32, 1, 257, "taps"), (8, 129, 1, 4, "ch"), (64, 32, 4, 64, "shared memory"),
])
def test_msda_geometry_refuses_what_the_kernel_does_not_take(heads, ch, L, P, match):
    with pytest.raises(ValueError, match=match):
        msda_ops.msda_launch_geometry(1, 10, heads, ch, L, P, 4)


@pytest.mark.parametrize("shape", [(64, 3, 7, 7), (256, 64, 1, 1), (8, 5, 3, 3), (24, 18),
                                   (3, 256), (512, 512, 3, 3)])
def test_kept_int8_matrix_is_the_per_call_one(shape):
    """The matrix made once equals what the layers built on every call:
    OIHW permuted to [O, kh, kw, I], K zero-padded to 16, bit for bit."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    wq, _ = quantize_weight(w)
    per_call = wq.permute(0, 2, 3, 1).reshape(shape[0], -1) if len(shape) == 4 else wq
    K = per_call.shape[1]
    per_call = F.pad(per_call, (0, (-K) % 16)).contiguous()
    got = int8_weight_matrix(wq)
    assert got.dtype == torch.int8 and got.is_contiguous() and got.shape[1] % 16 == 0
    assert torch.equal(got, per_call)


def test_layers_keep_the_matrix_and_drop_it_with_wq():
    torch.manual_seed(0)
    conv = QConv(5, 8, 3, stride=2, padding=1, quant="int8")
    dense = QDense(18, 6, quant="int8")
    x = torch.randn(2, 5, 9, 11)
    xd = torch.randn(3, 4, 18)
    for m in (conv, dense):
        attach_quant_scales(m, {"qdq_in": 0.03})
        assert m.wmat is not None and "wmat" not in m.state_dict()
    # the product as the layers computed it before the matrix was kept
    wq, ws = quantize_weight(conv.weight)
    s = conv.qdq_in.scale
    col, Ho, Wo = int8_im2col(_quantize_input(x, s), (3, 3), (2, 2), (1, 1), 16)
    w2 = F.pad(wq.permute(0, 2, 3, 1).reshape(8, -1), (0, col.shape[1] - 45))
    want = (int8_ops.int8_matmul_plain(col, w2.contiguous(), s, ws) + conv.bias)
    want = want.reshape(2, Ho, Wo, 8).permute(0, 3, 1, 2)
    assert torch.equal(conv(x), want)
    wq, ws = quantize_weight(dense.weight)
    xq = _quantize_input(xd, dense.qdq_in.scale).reshape(-1, 18)
    want = int8_ops.int8_matmul_plain(xq, wq, dense.qdq_in.scale, ws) + dense.bias
    assert torch.equal(dense(xd), want.reshape(3, 4, 6))

    # a load brings wq and drops the kept matrix; the first forward remakes it
    sd = conv.state_dict()
    conv.load_state_dict(sd)
    assert conv.wmat is None
    y = conv(x)
    assert torch.equal(conv.wmat, int8_weight_matrix(conv.wq)) and torch.equal(y, conv(x))
    fresh = QConv(5, 8, 3, stride=2, padding=1, quant="int8")
    fresh.load_state_dict(sd)
    assert fresh.wq is not None and fresh.wmat is None and torch.equal(fresh(x), y)
    # refolding drops the old matrix with the old wq
    with torch.no_grad():
        conv.weight.mul_(-1)
    attach_quant_scales(conv, {"qdq_in": 0.03})
    assert torch.equal(conv.wmat, int8_weight_matrix(quantize_weight(conv.weight)[0]))
    assert fold_int8_weights(conv).wmat is not None
