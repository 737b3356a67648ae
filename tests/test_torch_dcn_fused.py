"""The Python around the fused DCN kernel (`csrc/dcn_fused.cu`), on the CPU:
the weight matrix that the DCN block keeps (bit for bit `col_product`'s),
the kernel's walk over K (a chunk of channels through every tap, cut at the
group's end and at deform-group boundaries) reproducing the plain op from
the plain im2col, the tile configurations against a Hopper block's shared
memory, the gather table (channels last; the int8 codes of
`quantize_dcn_table`, whose formula the table kernel repeats with an IEEE
division), the scale's single reduction, and the grouped product of the
im2col route.  CPU tensors take the plain versions: nothing is built or
launched."""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.models.backbones.resnet import DeformConv2d
from bevformer_tensorrt_tpu_torch.ops import _cuda
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc

SM_SMEM = 233472  # shared memory of one H100 SM, 1 KB of it reserved per block


def case(N, Cin, H, W, Cout, stride, dg, groups, layout, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.standard_normal((N, Cin, H, W)).astype(np.float32)
    off = (rng.standard_normal((N, 2 * dg * 9, Ho, Wo)) * 2).astype(np.float32)
    mask = rng.random((N, dg * 9, Ho, Wo)).astype(np.float32)
    w = (rng.standard_normal((Cout, Cin // groups, 3, 3)) / np.sqrt(9 * Cin)).astype(np.float32)
    b = rng.standard_normal(Cout).astype(np.float32)
    x, off, mask = (torch.from_numpy(t) for t in (x, off, mask))
    if layout == "NHWC":
        x, off, mask = (t.permute(0, 2, 3, 1).contiguous() for t in (x, off, mask))
    return (x.to(dtype), off.to(dtype), mask.to(dtype), torch.from_numpy(w),
            torch.from_numpy(b))


def k_steps(cin_g, cpdg, g, bk, taps=9):
    """The kernel's walk (`next_step` / `chunk_len` / `step_shift` of the
    source): (tap, first channel of the group's chunk, channels, shift) of
    every K step, for steps of `bk` channels (128 bytes).  bfloat16 (64):
    TMA reads the K-major weight tile from the 16-byte boundary `shift`
    columns before the step, so a chunk is one 16-byte piece shorter where
    groups or deform groups are not whole pieces; float32 (32): K is the
    tile's outer axis, which TMA starts anywhere (no shift)."""
    ka = bk // 8 if bk == 64 else 1  # the boundary TMA starts a K-major box on, in channels
    cap = bk - (ka - 1 if cin_g % ka or cpdg % ka else 0)
    steps, c = [], 0
    while c < cin_g:
        start = g * cin_g + c
        length = min(cap, cin_g - c, cpdg - start % cpdg)
        steps += [(t, c, length, (t * cin_g + c) % ka) for t in range(taps)]
        c += length
    return steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((256, 256, 3, 3), 1), ((40, 24, 3, 3), 2), ((48, 32, 3, 3), 2), ((8, 5, 3, 3), 1),
    ((12, 7, 1, 3), 3),
])
def test_dcn_weight_matrix_is_col_products_w2(shape, groups, dtype):
    """Bit for bit the matrix that `col_product` builds on every call, K
    zero-padded to a multiple of 64: [Cout, K] in bfloat16; in float32 its
    transpose [K, Cout], Cout zero-padded to a multiple of 4."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    got = dcn_ops.dcn_weight_matrix(w, dtype)
    w2 = w.to(dtype).permute(0, 2, 3, 1).reshape(shape[0], -1)
    K, Cout = w2.shape[1], shape[0]
    assert got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        assert got.shape[1] % 4 == 0 and Cout <= got.shape[1] < Cout + 4
        got = got.t()
        assert not got[Cout:].any()
        got = got[:Cout]
    assert got.shape[0] == Cout
    assert got.shape[1] % dcn_ops.DCN_K_ALIGN == 0 and K <= got.shape[1] < K + 64
    assert torch.equal(got[:, :K], w2) and not got[:, K:].any()


def test_deform_block_keeps_its_matrix_per_dtype():
    """Made once per dtype and weight state: the same tensor again, a new one
    when the weight changes in place, none kept after a state_dict load."""
    torch.manual_seed(0)
    block = DeformConv2d(32, 16)
    with torch.no_grad():
        block.weight.normal_()
    m32 = block.weight_matrix(torch.float32)
    assert block.weight_matrix(torch.float32) is m32
    m16 = block.weight_matrix(torch.bfloat16)
    assert m16.dtype == torch.bfloat16 and block.weight_matrix(torch.float32) is m32
    assert torch.equal(m32, dcn_ops.dcn_weight_matrix(block.weight, torch.float32))
    with torch.no_grad():
        block.weight.mul_(-1)
    changed = block.weight_matrix(torch.float32)
    assert changed is not m32 and torch.equal(changed, -m32)
    sd = block.state_dict()
    assert not any("wmat" in k for k in sd)
    block.load_state_dict(sd)
    assert block._wmats == {}
    assert torch.equal(block.weight_matrix(torch.float32), changed)


def test_deform_block_drops_its_matrix_when_told_or_moved():
    """An edit through `weight.data` does not move the weight's version, so
    the kept matrix stays until `invalidate()`; a move or cast of the module
    drops it."""
    torch.manual_seed(1)
    block = DeformConv2d(16, 8)
    with torch.no_grad():
        block.weight.normal_()
    kept = block.weight_matrix(torch.float32)
    block.weight.data.mul_(2.0)
    assert block.weight_matrix(torch.float32) is kept  # the version did not move
    block.invalidate()
    fresh = block.weight_matrix(torch.float32)
    assert torch.equal(fresh, 2.0 * kept)
    assert torch.equal(fresh, dcn_ops.dcn_weight_matrix(block.weight, torch.float32))
    block.to(torch.float64).to(torch.float32)
    assert block._wmats == {}
    assert torch.equal(block.weight_matrix(torch.float32), fresh)


@pytest.mark.parametrize("bk", [32, 64])  # channels of a K step: float32, bfloat16
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("N,Cin,H,W,Cout,stride,dg,groups", [
    (2, 48, 9, 11, 40, 2, 2, 1),     # the deform groups cut a conv group's channels
    (1, 64, 7, 10, 48, 1, 2, 2),     # two conv groups, a deform group each
    (1, 96, 6, 9, 16, 1, 1, 1),      # K 864: ragged against 64
    (2, 40, 5, 7, 12, 1, 4, 2),      # deform groups of 10 in groups of 20: short steps
    (1, 72, 6, 5, 9, 2, 3, 3),
    (1, 7, 5, 6, 9, 1, 1, 1),        # 7 channels: every step starts off 16 bytes
    (1, 30, 5, 6, 10, 1, 3, 2),      # groups of 15, deform groups of 10
])
def test_k_walk_over_the_im2col_is_the_op(N, Cin, H, W, Cout, stride, dg, groups, layout, bk):
    """The fused kernel's product as its walk computes it: for each step,
    the weight matrix's columns from (tap, channel) on, times the sampled
    channels of that step (zero past its length, so the next tap's columns
    add nothing), summed; the sampled values are the plain im2col's.  That is
    the plain op to 1e-6, which pins the K order the kernel and its weight
    matrix share."""
    x, off, mask, w, b = case(N, Cin, H, W, Cout, stride, dg, groups, layout)
    geo = dict(stride=stride, padding=1, dilation=1, deform_groups=dg, layout=layout)
    col = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo).double()  # [N, 9 Cin, S]
    # [Cout, Kp]: (tap, channel) order as the kernels' matrices (float32 keeps its transpose)
    wmat = dcn_ops.dcn_weight_matrix(w, torch.float32).double().t()[:Cout]
    cin_g, cout_g = Cin // groups, Cout // groups
    S = col.shape[2]
    wpad = torch.nn.functional.pad(wmat, (0, bk))  # TMA reads zeros past the matrix
    out = torch.zeros(N, Cout, S, dtype=torch.float64)
    for g in range(groups):
        rows = slice(g * cout_g, (g + 1) * cout_g)
        for t, c, length, shift in k_steps(cin_g, Cin // dg, g, bk):
            k0 = t * cin_g + c - shift  # bfloat16: on a 16-byte boundary
            assert (k0 % 8 == 0 if bk == 64 else shift == 0) and shift + length <= bk
            b_tile = torch.zeros(N, bk, S, dtype=torch.float64)
            first = t * Cin + g * cin_g + c
            b_tile[:, shift:shift + length] = col[:, first:first + length]
            out[:, rows] += torch.einsum("ok,nks->nos", wpad[rows, k0:k0 + bk], b_tile)
    out = out + b.double()[None, :, None]
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, w, b, groups=groups, **geo)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = out.reshape(N, Cout, Ho, Wo)
    if layout == "NHWC":
        out = out.permute(0, 2, 3, 1)
    err = float((out - want.double()).abs().max() / want.double().abs().max())
    assert err < 1e-6
    # every (tap, channel) of a group is taken exactly once, within one deform group
    for g in range(groups):
        seen = [(t, c + i) for t, c, n, _ in k_steps(cin_g, Cin // dg, g, bk) for i in range(n)]
        assert sorted(seen) == [(t, c) for t in range(9) for c in range(cin_g)]
        for t, c, n, _ in k_steps(cin_g, Cin // dg, g, bk):
            a = g * cin_g + c
            assert 1 <= n <= bk and a // (Cin // dg) == (a + n - 1) // (Cin // dg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(set(kc.DCN_SHAPES) | set(kc.DCN_INT8_SHAPES)))
def test_dcn_configuration_fits_shared_memory(name, dtype):
    """The tile configuration `dcn_config` picks, with the deform-group and
    group splits of the shape: the kernel of the activation dtype, its
    shared memory (weight ring, two sampled tiles, corner table) within one
    block's 227 KB, the bfloat16 epilogue's staging within the ring and
    sampled tiles it reuses, two blocks an SM for the 128-row tile."""
    for spec in (kc.DCN_SHAPES.get(name), kc.DCN_INT8_SHAPES.get(name)):
        if spec is None:
            continue
        N, Cin, H, W, Cout, stride, dg = spec[:7]
        groups = spec[9]
        Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        config = dcn_ops.dcn_config(Cout // groups, dtype, groups, N * Ho * Wo)
        cdtype, bm, bn, bk = dcn_ops.DCN_CONFIGS[config]
        assert cdtype == dtype and bk * dtype.itemsize == 128
        assert bn == 128 or (dtype == torch.float32 and bn == 64)
        assert bm == (256 if dtype == torch.bfloat16 and Cout // groups > 128 else 128)
        smem = dcn_ops.dcn_smem_bytes(config, 9)
        assert smem <= dcn_ops.SMEM_LIMIT
        ring = dcn_ops.A_STAGES * bm * 128 + 2 * bn * 128
        for pixel_major in (True, False):
            assert dcn_ops.dcn_epilogue_bytes(config, pixel_major) <= ring
        if config != "bf16_256x128":  # two blocks an SM
            assert 2 * (smem + 1024) <= SM_SMEM
        tiles = groups * -(-(Cout // groups) // bm) * -(-N * Ho * Wo // bn)  # one grid axis
        assert tiles < 2 ** 31 and N * Ho * Wo < 2 ** 31
        assert (Cin // groups) % (16 // dtype.itemsize) == 0  # whole 16-byte pieces (vec_x)


def test_dcn_configuration_rule():
    """The 256-row bfloat16 tile where a group has more than 128 outputs
    (base's and small's DCN shapes), else the 128-row one; float32 the
    128-pixel FFMA tile where its tiles fill the blocks an H100 holds at once
    (two on each of 132 SMs), else the 64-pixel one; the pixel tiles run
    across the images."""
    for name, want in (("base_s3", "f32_128x128"), ("base_s4", "f32_128x128"),
                       ("small_s3", "f32_128x128"), ("small_s4", "f32_128x64")):
        N, _, H, W, Cout = kc.DCN_SHAPES[name][:5]
        assert dcn_ops.dcn_config(Cout, torch.float32, 1, N * H * W) == want, name
    assert dcn_ops.dcn_config(128, torch.float32, 1, 128 * 264) == "f32_128x128"
    assert dcn_ops.dcn_config(128, torch.float32, 1, 128 * 263) == "f32_128x64"
    assert dcn_ops.dcn_config(128, torch.float32, 1, 128 * 263, sms=100) == "f32_128x128"
    assert dcn_ops.dcn_config(256, torch.bfloat16) == "bf16_256x128"
    assert dcn_ops.dcn_config(512, torch.bfloat16) == "bf16_256x128"
    assert dcn_ops.dcn_config(128, torch.bfloat16) == "bf16_128x128"
    assert dcn_ops.dcn_config(24, torch.bfloat16) == "bf16_128x128"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcn_ops.dcn_config(256, torch.float16)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_table_codes_are_the_quantizers(layout, dtype):
    """The table kernel's formula, q = clamp(rint(x / s), -127, 127) with an
    IEEE float32 division and round half to even, written here with numpy,
    gives `quantize_dcn_table`'s codes on maps that hold exact half-steps,
    values at +-127.5 s and a silent channel group; the plain table is the
    same codes with the channels last."""
    rng = np.random.default_rng(3)
    N, C, H, W, chg = 2, 96, 5, 6, 32
    x = rng.standard_normal((N, C, H, W)).astype(np.float32)
    x[:, 64:] = 0.0  # a silent group
    amax = np.abs(x[:, :32]).max(axis=(1, 2, 3), keepdims=True)
    step = amax / 127.0
    x[:, :32, 0, :5] = (np.arange(5) + 0.5)[None, None, :] * step[:, :, 0]  # k + 1/2 steps
    x[:, :32, 1, 0] = -amax[:, :, 0, 0]
    x[:, 32:64] = rng.choice([-127.5, -2.5, -0.5, 0.5, 1.5, 126.5], size=(N, 32, H, W))
    xt = torch.from_numpy(x).to(dtype)
    if layout == "NHWC":
        xt = xt.permute(0, 2, 3, 1).contiguous()
    q, scale = dcn_ops.quantize_dcn_table(xt, chg, layout)
    xf = (xt if layout == "NCHW" else xt.permute(0, 3, 1, 2)).float().numpy()
    s = np.repeat(scale.numpy(), chg, axis=1)[:, :, None, None].astype(np.float32)
    want = np.clip(np.rint(np.divide(xf, s, dtype=np.float32)), -127, 127).astype(np.int8)
    got = (q if layout == "NCHW" else q.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[:, :32]) == 127).any() and not got[:, 64:].any()
    if dtype == torch.float32:  # bfloat16 does not hold the half-steps exactly
        halves = np.abs(want[:, :32, 0, :5]).astype(np.float64)
        assert (halves % 2 == 0).all()  # k + 1/2 rounds to the even neighbour
    table, tscale = dcn_ops.dcn_gather_table(xt, layout, chg)
    assert torch.equal(tscale, scale)
    assert torch.equal(table, q if layout == "NHWC" else q.permute(0, 2, 3, 1))
    table, none = dcn_ops.dcn_gather_table(xt, layout)
    assert none is None and table.is_contiguous()
    assert torch.equal(table, xt if layout == "NHWC" else xt.permute(0, 2, 3, 1))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_scale_is_one_reduction(layout, dtype):
    """max(max x, -min x) over each channel is max |x| exactly: the scale is
    the one `abs().amax()` gave, bit for bit."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 128, 7, 9)).astype(np.float32)).to(dtype)
    x[1, 64:] = 0.0
    x[0, 3, 2, 2] = -50.0  # a group whose largest magnitude is negative
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    for chg in (32, 64):
        got = dcn_ops.dcn_table_scale(x, chg, layout)
        xf = x.float().abs().amax(dim=(1, 2) if layout == "NHWC" else (2, 3))
        want = xf.reshape(2, 128 // chg, chg).amax(-1).clamp_min(1e-12) / 127.0
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("groups", [2, 4])
def test_col_product_takes_groups(groups, layout):
    """The im2col route's product with `groups`: each group's rows times its
    weights, the plain op to 1e-6."""
    x, off, mask, w, b = case(2, 32, 6, 7, 24, 1, 2, groups, layout, seed=5)
    geo = dict(stride=1, padding=1, dilation=1, deform_groups=2, layout=layout)
    col = dcn_ops.deform_im2col_plain(x, off, mask, (3, 3), **geo)
    got = dcn_ops.col_product(col, w, b, 6, 7, layout, groups)
    want = dcn_ops.modulated_deform_conv2d_plain(x, off, mask, w, b, groups=groups, **geo)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the op, its int8 entry and the table run their plain
    versions: equal to them, nothing launched, nothing built."""
    ops.reset_launch_counts()
    x, off, mask, w, b = case(1, 64, 6, 7, 16, 1, 1, 1, "NCHW", seed=6)
    got = ops.modulated_deform_conv2d(x, off, mask, w, b, quant="int8")
    want = ops.modulated_deform_conv2d_plain(x, off, mask, w, b, quant="int8")
    assert torch.equal(got, want)
    assert torch.equal(ops.modulated_deform_conv2d_int8(x, off, mask, w, b),
                       ops.modulated_deform_conv2d_int8_plain(x, off, mask, w, b))
    assert torch.equal(ops.modulated_deform_conv2d(x, off, mask, w, b),
                       ops.modulated_deform_conv2d_plain(x, off, mask, w, b))
    assert torch.equal(ops.dcn_gather_table(x, "NCHW", 32)[0],
                       dcn_ops.dcn_gather_table_plain(x, "NCHW", 32)[0])
    with pytest.raises(ValueError, match="int8 table takes"):
        ops.modulated_deform_conv2d_int8(x, off, mask, w[:, :32].contiguous(), b, groups=2)
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * len(ops.KERNEL_WRAPPERS)
    assert "dcn_fused" not in _cuda._libs
