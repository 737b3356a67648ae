"""The PyTorch port's ops against the JAX package's (CPU, float32).

MSDA: the port's plain version (through the public dispatcher, on CPU
tensors) against `multi_scale_deformable_attn`, its unchunked reference and
the Pallas sorted-tap kernel in interpret mode, over 1 and 4 levels, ppg 1
and 4, with offsets that push samples past every border.  Attention: the
port's plain version against `qkv` and the Pallas flash kernel in interpret
mode at a ragged length.  DCNv2: the port's plain version against
`modulated_deform_conv2d(impl="jnp")` over deform groups, strides, both
layouts, with and without bias, against the Pallas im2col kernel in interpret
mode, against `F.conv2d` at zero offsets, and at the exact border positions
against the scalar oracle of test_ops_misc.py.  Every comparison holds a
relative error of 1e-5, except the int8 gather table of the DCN im2col
against the Pallas kernel, whose bar is stated at the test.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu.ops import (
    modulated_deform_conv2d as jax_dcn,
    multi_scale_deformable_attn as jax_msda,
    multi_scale_deformable_attn_reference as jax_msda_reference,
    multi_scale_deformable_attn_sorted as jax_msda_sorted,
    qkv as jax_qkv,
)
from bevformer_tensorrt_tpu.ops import msda_sampling_locations as jax_locations
from bevformer_tensorrt_tpu.ops.dcn import _dcn_pallas as jax_dcn_pallas
from bevformer_tensorrt_tpu.ops.pallas.flash_attn import flash_attention as jax_flash
from bevformer_tensorrt_tpu_torch.ops import (
    deform_im2col_plain,
    flash_attention,
    modulated_deform_conv2d,
    modulated_deform_conv2d_plain,
    msda_sampling_locations,
    multi_head_attention,
    multi_scale_deformable_attn,
)
from bevformer_tensorrt_tpu_torch.ops.dcn import col_product
from torch_port_helpers import rel

torch.set_num_threads(2)

TOL = 1e-5

MSDA_CASES = {
    # name: (spatial_shapes, bs, nq, heads, ch, P, ppg)
    "L1_ppg1": (((10, 12),), 2, 40, 4, 8, 4, 1),
    "L1_ppg4": (((10, 12),), 3, 40, 4, 8, 8, 4),
    "L4_ppg1": (((16, 20), (8, 10), (4, 5), (2, 3)), 2, 30, 2, 8, 4, 1),
    "L4_ppg4": (((16, 20), (8, 10), (4, 5), (2, 3)), 2, 30, 2, 8, 8, 4),
}


def msda_case(name, rng):
    shapes, bs, nq, heads, ch, P, ppg = MSDA_CASES[name]
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = rng.standard_normal((bs, keys, heads, ch)).astype(np.float32)
    # references spread a little past [0, 1] and offsets of several pixels
    # put samples outside every border
    ref = rng.uniform(-0.1, 1.1, (bs, nq, 1, ppg * 2)).astype(np.float32)
    off = (rng.standard_normal((bs, nq, heads, L * P * 2)) * 3).astype(np.float32)
    attn = rng.standard_normal((bs, nq, heads, L * P)).astype(np.float32)
    return shapes, value, ref, off, attn


def port_msda(shapes, value, ref, off, attn):
    out = multi_scale_deformable_attn(*(torch.from_numpy(a) for a in (value, ref, off, attn)),
                                      shapes)
    return out.numpy()


@pytest.mark.parametrize("case", sorted(MSDA_CASES))
def test_msda_matches_jax(case, rng):
    shapes, value, ref, off, attn = msda_case(case, rng)
    got = port_msda(shapes, value, ref, off, attn)
    assert rel(got, jax_msda(value, ref, off, attn, shapes)) < TOL
    assert rel(got, jax_msda_reference(value, ref, off, attn, shapes)) < TOL


@pytest.mark.parametrize("case", ["L1_ppg4", "L4_ppg1"])
def test_msda_matches_pallas_interpret(case, rng):
    """The TPU kernel itself (sorted-tap gather, f32 tables) in interpret mode."""
    shapes, value, ref, off, attn = msda_case(case, rng)
    want = jax_msda_sorted(value, ref, off, attn, shapes, packed=False, interpret=True)
    assert rel(port_msda(shapes, value, ref, off, attn), want) < TOL


def test_msda_border_samples_exact(rng):
    """Samples wholly outside every border contribute exactly 0; samples
    half outside keep only their in-image corners, as in JAX."""
    shapes = ((6, 8),)
    value = rng.standard_normal((1, 48, 1, 4)).astype(np.float32)
    ref = np.array([[-0.5, 0.5], [1.5, 0.5], [0.5, -0.5], [0.5, 1.5],
                    [0.0, 0.5], [1.0, 1.0]], np.float32).reshape(1, 6, 1, 2)
    off = np.zeros((1, 6, 1, 2), np.float32)
    attn = np.zeros((1, 6, 1, 1), np.float32)
    got = port_msda(shapes, value, ref, off, attn)
    np.testing.assert_array_equal(got[0, :4], 0.0)
    np.testing.assert_allclose(got, np.asarray(jax_msda_reference(value, ref, off, attn, shapes)),
                               rtol=1e-6, atol=1e-7)


def test_sampling_locations_point_order(rng):
    """Point p of a level uses reference group p % ppg (ppg innermost)."""
    shapes = ((10, 12), (5, 6))
    ref = rng.random((2, 7, 1, 8)).astype(np.float32)
    off = rng.standard_normal((2, 7, 3, 2 * 8 * 2)).astype(np.float32)
    got = msda_sampling_locations(torch.from_numpy(ref), torch.from_numpy(off), shapes, 3)
    want = np.asarray(jax_locations(ref, off, shapes, 3))
    assert got.shape == want.shape == (2, 7, 3, 2, 8, 2)
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("Lq,Lk,d", [(37, 37, 32), (100, 61, 64)])
def test_attention_matches_jax(Lq, Lk, d, rng):
    q = rng.standard_normal((3, Lq, d)).astype(np.float32)
    k = rng.standard_normal((3, Lk, d)).astype(np.float32)
    v = rng.standard_normal((3, Lk, d)).astype(np.float32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert rel(got, jax_qkv(q, k, v)) < TOL
    want = jax_flash(q, k, v, block_q=64, block_k=64, interpret=True)
    assert rel(got, want) < TOL


def test_multi_head_split_merge(rng):
    from bevformer_tensorrt_tpu.ops import multi_head_attention as jax_mha

    q, k, v = (rng.standard_normal((1, 50, 64)).astype(np.float32) for _ in range(3))
    got = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), num_heads=4).numpy()
    assert rel(got, jax_mha(q, k, v, num_heads=4)) < TOL


def test_cpu_inputs_take_the_plain_path(rng):
    """On CPU tensors the wrappers run their plain versions and launch
    nothing."""
    from bevformer_tensorrt_tpu_torch import ops

    ops.reset_launch_counts()
    shapes, value, ref, off, attn = msda_case("L1_ppg1", rng)
    port_msda(shapes, value, ref, off, attn)
    q = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    flash_attention(q, q, q)
    x, offset, mask, weight, _ = dcn_case(rng, dg=1, stride=1)
    port_dcn(x, offset, mask, weight, None)
    ops.flash_attention_int8(q, q, q)
    ops.multi_scale_deformable_attn_int8(*(torch.from_numpy(a) for a in (value, ref, off, attn)),
                                         shapes)
    xi = torch.ones(3, 16, dtype=torch.int8)
    ops.int8_matmul.int8_matmul(xi, xi[:2], 0.5, torch.ones(2))
    port_dcn(*dcn_case(rng, dg=1, stride=1, Cin=32)[:4], None, quant="int8")
    xq = torch.from_numpy(dcn_case(rng, dg=1, stride=1, Cin=32)[0])
    q8, scale = ops.quantize_dcn_table(xq, 32)
    ops.deform_im2col_int8(q8, scale, torch.zeros(2, 18, 9, 11), torch.ones(2, 9, 9, 11), (3, 3))
    table = torch.from_numpy(rng.standard_normal((2, 40, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (2, 5, 3, 4)).astype(np.int32))
    ops.gather_rows(table, idx.reshape(2, -1))
    ops.gather_blend(table, idx, torch.ones(2, 5, 3, 4))
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 12


def dcn_case(rng, dg, stride, N=2, Cin=8, H=9, W=11, Cout=6, groups=1):
    """NCHW numpy inputs; offsets of 1.5 pixels rms put samples of the
    outer pixels past every border."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.standard_normal((N, Cin, H, W)).astype(np.float32)
    offset = (rng.standard_normal((N, 2 * dg * 9, Ho, Wo)) * 1.5).astype(np.float32)
    mask = rng.random((N, dg * 9, Ho, Wo)).astype(np.float32)
    weight = (rng.standard_normal((Cout, Cin // groups, 3, 3)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(Cout).astype(np.float32)
    return x, offset, mask, weight, bias


def nhwc(*arrays):
    return tuple(np.ascontiguousarray(a.transpose(0, 2, 3, 1)) for a in arrays)


def port_dcn(x, offset, mask, weight, bias, fn=modulated_deform_conv2d, **kw):
    args = [None if a is None else torch.from_numpy(a) for a in (x, offset, mask, weight, bias)]
    return fn(*args, **kw).numpy()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dg", [1, 2])
def test_dcn_matches_jax(dg, stride, layout, with_bias, rng):
    x, offset, mask, weight, bias = dcn_case(rng, dg, stride)
    bias = bias if with_bias else None
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
    kw = dict(stride=stride, padding=1, dilation=1, groups=1, deform_groups=dg, layout=layout)
    want = np.asarray(jax_dcn(x, offset, mask, weight, bias, impl="jnp", **kw))
    got = port_dcn(x, offset, mask, weight, bias, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel(got, want) < TOL


@pytest.mark.parametrize("stride,cin,layout", [(1, 32, "NCHW"), (2, 64, "NCHW"), (1, 32, "NHWC")])
def test_dcn_matches_pallas_interpret(stride, cin, layout, rng):
    """The TPU kernel itself (sorted-gather im2col, f32 tables) in interpret
    mode, then its GEMM."""
    x, offset, mask, weight, _ = dcn_case(rng, 1, stride, Cin=cin, Cout=8)
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
    want = np.asarray(jax_dcn_pallas(x, offset, mask, weight, stride, 1, 1, packed=False,
                                     interpret=True, layout=layout))
    got = port_dcn(x, offset, mask, weight, None, stride=stride, layout=layout)
    assert rel(got, want) < TOL


def test_dcn_zero_offset_equals_conv(rng):
    """With zero offsets and a unit mask the op is an ordinary convolution."""
    x = rng.standard_normal((2, 4, 8, 9)).astype(np.float32)
    weight = (rng.standard_normal((5, 4, 3, 3)) * 0.2).astype(np.float32)
    for stride in (1, 2):
        Ho, Wo = (8 - 1) // stride + 1, (9 - 1) // stride + 1
        offset = np.zeros((2, 18, Ho, Wo), np.float32)
        mask = np.ones((2, 9, Ho, Wo), np.float32)
        got = port_dcn(x, offset, mask, weight, None, stride=stride)
        want = F.conv2d(torch.from_numpy(x), torch.from_numpy(weight), stride=stride, padding=1)
        assert rel(got, want.numpy()) < TOL


def test_dcn_border_edges_exact(rng):
    """A 1x1 kernel without padding samples at pixel + offset.  Positions
    exactly on and next to the validity edges (-1, just inside -1, H - 1,
    just past H - 1, H, and far out) follow the scalar oracle: zero at
    p <= -1 and p >= size, only the in-map corners in between."""
    H, W = 5, 6
    ys = np.array([-1.0, -0.999, -0.5, 0.0, H - 1.0, H - 1 + 1e-3, H - 0.5, H, -1e9, 1e9, 3e38],
                  np.float32)
    xs = np.array([-1.0, -0.999, -0.5, 0.0, W - 1.0, W - 1 + 1e-3, W - 0.5, W, -1e9, 1e9, 3e38],
                  np.float32)
    x = rng.standard_normal((1, 2, H, W)).astype(np.float32)
    weight = np.ones((1, 2, 1, 1), np.float32)
    mask = np.ones((1, 1, H, W), np.float32)

    def oracle(py, px):  # the rule of test_ops_misc.py::numpy_dcn_oracle, summed over channels
        if py <= -1 or py >= H or px <= -1 or px >= W:
            return 0.0
        y0, x0 = int(np.floor(py)), int(np.floor(px))
        v = 0.0
        for yy, wy in ((y0, 1 - (py - y0)), (y0 + 1, py - y0)):
            for xx, wx in ((x0, 1 - (px - x0)), (x0 + 1, px - x0)):
                if 0 <= yy < H and 0 <= xx < W:
                    v += wy * wx * x[0, :, yy, xx].astype(np.float64).sum()
        return v

    for py in ys:  # one call per position, sampled from output pixel (0, 0)
        for px in xs:
            offset = np.zeros((1, 2, H, W), np.float32)
            offset[0, 0, 0, 0], offset[0, 1, 0, 0] = py, px
            got = port_dcn(x, offset, mask, weight, None, padding=0)[0, 0, 0, 0]
            assert np.isfinite(got)
            if py <= -1 or py >= H or px <= -1 or px >= W:
                assert got == 0.0, (py, px)
            np.testing.assert_allclose(got, oracle(float(py), float(px)), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{py}, {px}")


def test_dcn_groups_match_jax(rng):
    x, offset, mask, weight, bias = dcn_case(rng, dg=2, stride=1, groups=2)
    kw = dict(stride=1, padding=1, dilation=1, groups=2, deform_groups=2)
    want = np.asarray(jax_dcn(x, offset, mask, weight, bias, impl="jnp", **kw))
    assert rel(port_dcn(x, offset, mask, weight, bias, **kw), want) < TOL


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dg,stride", [(1, 1), (2, 2), (4, 1)])
def test_dcn_im2col_then_product_matches_plain(dg, stride, layout, rng):
    """The card's formulation (column matrix, then one product with the
    weight) on the plain im2col equals the per-tap plain op."""
    x, offset, mask, weight, bias = dcn_case(rng, dg, stride)
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
    kw = dict(stride=stride, padding=1, dilation=1, deform_groups=dg, layout=layout)
    want = port_dcn(x, offset, mask, weight, bias, fn=modulated_deform_conv2d_plain, **kw)
    xt, ot, mt, wt, bt = (torch.from_numpy(a) for a in (x, offset, mask, weight, bias))
    col = deform_im2col_plain(xt, ot, mt, (3, 3), **kw)
    Ho, Wo = want.shape[1:3] if layout == "NHWC" else want.shape[2:]
    assert tuple(col.shape) == (2, 9 * 8, Ho * Wo)
    got = col_product(col, wt, bt, Ho, Wo, layout).numpy()
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_dcn_refuses_wrong_shapes(rng):
    x, offset, mask, weight, _ = dcn_case(rng, dg=1, stride=1)
    with pytest.raises(ValueError, match="offset"):
        port_dcn(x, offset[:, :, :-1], mask, weight, None)
    with pytest.raises(ValueError, match="layout"):
        port_dcn(x, offset, mask, weight, None, layout="NCWH")
    with pytest.raises(ValueError, match="groups"):
        port_dcn(x, offset, mask, weight, None, groups=3)


# ---- the int8 gather table of the DCN im2col --------------------------------

def numpy_dcn_table(x, ch_group):
    """The formula on an NCHW float32 map: (codes int8, scale [N, G])."""
    N, C, H, W = x.shape
    g = x.astype(np.float32).reshape(N, C // ch_group, ch_group * H * W)
    scale = (np.maximum(np.abs(g).max(-1), np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)
    codes = np.clip(np.round(g / scale[:, :, None]), -127, 127).astype(np.int8)
    return codes.reshape(N, C, H, W), scale


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("cin,ch_group", [(64, 64), (128, 64), (96, 32)])
def test_dcn_table_quantizer_matches_jax_and_the_formula(cin, ch_group, layout, rng):
    """`quantize_dcn_table`: the scale equals the one the JAX package's
    table-packing functions return (1e-7 relative; `_pack_tables_from_vt` for NCHW,
    `_pack_tables_from_xlast` for NHWC), the codes equal the numpy formula
    exactly, with one channel group all zero and one far louder than the rest."""
    from bevformer_tensorrt_tpu.ops.msda import _pack_tables_from_vt, _pack_tables_from_xlast
    from bevformer_tensorrt_tpu_torch.ops.dcn import dcn_ch_group, quantize_dcn_table

    assert dcn_ch_group(cin) == ch_group
    N, H, W = 2, 5, 7
    x = rng.standard_normal((N, cin, H, W)).astype(np.float32)
    x[0, :ch_group] = 0.0          # an all-zero group: scale 1e-12 / 127, codes 0
    x[1, -ch_group:] *= 30.0
    want_codes, want_scale = numpy_dcn_table(x, ch_group)
    G = cin // ch_group
    if layout == "NHWC":
        xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        _, _, jax_scale = _pack_tables_from_xlast(xl.reshape(N, H * W, cin), ch_group, ((H, W),),
                                                  "int8")
        q, scale = quantize_dcn_table(torch.from_numpy(xl), ch_group, "NHWC")
        codes = q.numpy().transpose(0, 3, 1, 2)
    else:
        _, _, jax_scale = _pack_tables_from_vt(x.reshape(N * G, ch_group, H * W), ((H, W),), "int8")
        q, scale = quantize_dcn_table(torch.from_numpy(x), ch_group, "NCHW")
        codes = q.numpy()
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and tuple(scale.shape) == (N, G)
    np.testing.assert_allclose(scale.numpy().reshape(-1), np.asarray(jax_scale), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(scale.numpy(), want_scale)
    np.testing.assert_array_equal(codes, want_codes)
    assert (codes[0, :ch_group] == 0).all() and np.abs(codes).max() == 127
    with pytest.raises(ValueError, match="ch_group"):
        quantize_dcn_table(torch.from_numpy(x), 40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,cin", [(1, 64), (2, 96)])
def test_dcn_int8_plain_is_the_float_op_on_the_dequantized_map(stride, cin, layout, dtype, rng):
    """`quant="int8"`: the op and its im2col equal the floating-point plain
    versions on `q * scale` to 1e-6 (the same arithmetic on the same map);
    with bfloat16 activations the table is made in float32 from the bfloat16
    map and the output rounded to bfloat16 once (one step: 1e-2)."""
    from bevformer_tensorrt_tpu_torch import ops
    from bevformer_tensorrt_tpu_torch.ops.dcn import dcn_ch_group, dequantize_dcn_table

    x, offset, mask, weight, bias = dcn_case(rng, 1, stride, Cin=cin, Cout=8)
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
    xt, ot, mt = (torch.from_numpy(a).to(dtype) for a in (x, offset, mask))
    wt, bt = torch.from_numpy(weight), torch.from_numpy(bias)
    kw = dict(stride=stride, padding=1, dilation=1, deform_groups=1, layout=layout)
    q, scale = ops.quantize_dcn_table(xt, dcn_ch_group(cin), layout)
    deq = dequantize_dcn_table(q, scale, layout)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    got = ops.modulated_deform_conv2d(xt, ot, mt, wt, bt, quant="int8", **kw)
    want = modulated_deform_conv2d_plain(deq, ot.float(), mt.float(), wt, bt, **kw)
    assert got.dtype == dtype and rel(got.float().numpy(), want.numpy()) < tol
    col = ops.deform_im2col_int8(q, scale, ot, mt, (3, 3), **kw)
    want_col = deform_im2col_plain(deq, ot.float(), mt.float(), (3, 3), **kw)
    assert col.dtype == dtype and rel(col.float().numpy(), want_col.numpy()) < tol
    full = modulated_deform_conv2d_plain(xt, ot, mt, wt, bt, **kw)
    assert 1e-4 < rel(got.float().numpy(), full.float().numpy()) < 5e-2  # the table is in use


@pytest.mark.parametrize("stride,cin,layout", [(1, 64, "NCHW"), (2, 64, "NCHW"), (1, 96, "NHWC"),
                                               (1, 128, "NHWC")])
def test_dcn_int8_matches_pallas_interpret(stride, cin, layout, rng):
    """The TPU kernel with its int8 table (`packed="int8"`) in interpret
    mode.  That kernel rounds the map to bfloat16 before it quantizes, and
    the blend weights, the emitted columns and the weight to bfloat16 after,
    none of which the port carries over.  So both get a map and a weight
    that bfloat16 holds exactly (then the two tables hold the same codes)
    and what is left is the bfloat16 of the blend weights and the columns:
    measured 2.1e-3 to 4.1e-3 of the output's scale over these cases and four
    seeds, held at 6e-3, while the table itself moves the output by 7e-3 to
    1.3e-2 (with a map that bfloat16 does not hold, rounding it first flips
    about a quarter of the larger codes and the two differ by 5.5e-3 to
    9.2e-3).  Both stay within the 3% of the floating-point op that
    tests/test_ops_misc.py holds the Pallas kernel to."""
    x, offset, mask, weight, _ = dcn_case(rng, 1, stride, Cin=cin, Cout=8)
    x, weight = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, weight))
    full = port_dcn(x, offset, mask, weight, None, stride=stride)
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
        full = full.transpose(0, 2, 3, 1)
    want = np.asarray(jax_dcn_pallas(x, offset, mask, weight, stride, 1, 1, packed="int8",
                                     interpret=True, layout=layout))
    got = port_dcn(x, offset, mask, weight, None, stride=stride, layout=layout, quant="int8")
    assert got.shape == want.shape
    assert rel(got, want) < 6e-3
    assert 6e-3 < rel(got, full) < 3e-2 and rel(want, full) < 3e-2


@pytest.mark.parametrize("stride,cin,layout", [(1, 64, "NCHW"), (2, 64, "NCHW"), (1, 96, "NHWC"),
                                               (1, 128, "NHWC")])
def test_dcn_int8_columns_match_pallas_interpret(stride, cin, layout, rng):
    """The same comparison on the im2col columns, with room on both sides.
    A weight of zeros and ones that copies column row t*Cin + c to output
    channel t*Cin + c makes both ops return their columns (bfloat16 holds it
    exactly).  The first channel of every scale group is 16 times louder
    than the rest, so the group's step is 16 times coarser for the other
    channels, and only those are compared.  Over these cases and the numpy
    seeds 0 to 3 the port's columns differ from the TPU kernel's (the
    bfloat16 of its blend weights and columns) by 4.7e-3 to 8.1e-3 of the
    columns' scale, and both differ from the floating-point columns by
    4.6e-2 to 7.4e-2: one bar, 2e-2, a factor of two or more from either."""
    from bevformer_tensorrt_tpu_torch.ops.dcn import dcn_ch_group

    x, offset, mask, _, _ = dcn_case(rng, 1, stride, Cin=cin, Cout=8)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    loud = np.arange(0, cin, dcn_ch_group(cin))
    x[:, loud] *= 16
    weight = np.zeros((9 * cin, cin, 3, 3), np.float32)
    for t in range(9):
        weight[t * cin + np.arange(cin), np.arange(cin), t // 3, t % 3] = 1
    quiet = np.setdiff1d(np.arange(9 * cin), (np.arange(9)[:, None] * cin + loud).ravel())
    full = port_dcn(x, offset, mask, weight, None, stride=stride)
    if layout == "NHWC":
        x, offset, mask = nhwc(x, offset, mask)
        full = full.transpose(0, 2, 3, 1)
    want = np.asarray(jax_dcn_pallas(x, offset, mask, weight, stride, 1, 1, packed="int8",
                                     interpret=True, layout=layout))
    got = port_dcn(x, offset, mask, weight, None, stride=stride, layout=layout, quant="int8")
    assert got.shape == want.shape
    got, want, full = (np.take(a, quiet, axis=3 if layout == "NHWC" else 1)
                       for a in (got, want, full))
    assert rel(got, want) < 2e-2
    assert 2e-2 < rel(got, full) < 0.15 and 2e-2 < rel(want, full) < 0.15


@pytest.mark.parametrize("dg,cin", [(2, 64), (1, 48)])
def test_dcn_int8_on_a_shape_that_is_not_eligible_is_the_float_op(dg, cin, rng):
    """Two deform groups, or a width that 32 does not divide: the JAX op
    computes the floating-point result and ignores `quant`, and so does the
    port, bit for bit."""
    from bevformer_tensorrt_tpu_torch.ops.dcn import int8_table_eligible

    assert not int8_table_eligible(cin, 1, dg) and int8_table_eligible(64, 1, 1)
    assert not int8_table_eligible(64, 2, 1)
    x, offset, mask, weight, bias = dcn_case(rng, dg, 1, Cin=cin)
    kw = dict(stride=1, padding=1, dilation=1, groups=1, deform_groups=dg)
    got = port_dcn(x, offset, mask, weight, bias, quant="int8", **kw)
    np.testing.assert_array_equal(got, port_dcn(x, offset, mask, weight, bias, **kw))
    want = np.asarray(jax_dcn(x, offset, mask, weight, bias, impl="jnp", quant="int8", **kw))
    assert rel(got, want) < TOL
    np.testing.assert_array_equal(port_dcn(x, offset, mask, weight, bias, quant=True, **kw), got)
