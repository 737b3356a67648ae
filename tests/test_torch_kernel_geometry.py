"""The Python around the port's int8 product, MSDA, fused DCN and flash
attention kernels, on the CPU: the rule that picks the product's tile
configuration, the TMA
tensor-map arguments and their checks, the MSDA launch geometry (several
phase-1 passes and channel chunks where one block cannot take a problem;
every shape of one pass and one chunk exactly as before), the fused DCN
kernel's tile configuration and its walk over K, the weight matrices
that the quantized layers and the DCN block keep, and the flash kernels'
launch geometry and the numerics of their fragment layouts (numpy models of
the split-TF32 products and of the int8 P.V key permutation).  Every configuration and
geometry must fit in the shared memory of one Hopper block (227 KB) at
every shape of `tools/kernel_cases.py`."""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense, _quantize_input, int8_im2col
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import knobs
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
    if M * N >= knobs.get("GEMM_SMALL_OUTPUTS"):  # the large tiles leave no SM without a tile
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
    small = knobs.get("GEMM_SMALL_OUTPUTS")
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
    """name: (bs, shapes, nq, P, ch, heads) of every MSDA shape of the cases."""
    specs = {n: (s[0], s[1], s[2], s[3], 32, 8) for n, s in kc.MSDA_SHAPES.items()}
    specs.update({n: (s[0], s[1], s[2], s[3], s[5], s[6])
                  for n, s in kc.MSDA_EDGE_SHAPES.items()})
    return specs


def one_pass_msda_geometry(bs, nq, heads, ch, L, P, value_esz, value_ptr=0):
    """The launch geometry as it was before the kernel took any L*P, ch and
    heads x taps (one pass, one chunk): the shapes it took must keep it."""
    LP = L * P
    lpp = 1 << (LP - 1).bit_length()
    if lpp > 256 or not 1 <= ch <= 128:
        return None
    qt = max(1, min(nq, 1024 // (heads * lpp), -(-bs * nq // (4 * 132))))
    smem = 8 * qt * heads * (4 * lpp + 2)
    if smem > 232448:
        return None
    row = ch * value_esz
    vw = 16
    while row % vw or value_ptr % vw:
        vw //= 2
    lanes = row // vw
    rpw = 1
    while 2 * rpw * lanes <= 32:
        rpw *= 2
    seg = 1
    while seg < rpw and rpw // seg * 8 > qt * heads:
        seg *= 2
    return dict(qt=qt, threads=256, lpp=lpp, vw=vw, seg=seg, smem=smem, lanes_per_row=lanes,
                rows_per_warp=rpw, blocks=bs * -(-nq // qt))


@pytest.mark.parametrize("esz", [4, 2, 1])
@pytest.mark.parametrize("name", sorted(msda_specs()))
def test_msda_geometry_fits_every_shape(name, esz):
    bs, shapes, nq, P, ch, heads = msda_specs()[name]
    L = len(shapes)
    geo = msda_ops.msda_launch_geometry(bs, nq, heads, ch, L, P, esz, 0)
    lpp, qt, passes, cch = geo["lpp"], geo["qt"], geo["passes"], geo["cch"]
    assert lpp & (lpp - 1) == 0 and lpp <= msda_ops.MSDA_THREADS
    assert lpp * passes >= L * P > lpp * (passes - 1)  # the passes take every tap once
    assert passes == 1 or L * P > msda_ops.MSDA_THREADS or qt == 1
    assert geo["threads"] == 256 and geo["threads"] % min(lpp, 256) == 0
    assert 1 <= qt <= nq and (qt * heads * lpp <= knobs.get("MSDA_TAPS_PER_BLOCK") or qt == 1)
    multi = qt * heads * (8 + 4 * cch) if passes > 1 else 0
    assert geo["smem"] == 8 * qt * heads * (4 * lpp + 2) + multi <= msda_ops.SMEM_LIMIT
    assert cch == min(ch, msda_ops.MSDA_MAX_CH) and geo["chunks"] == -(-ch // cch)
    assert geo["vw"] == 16 and geo["lanes_per_row"] == cch * esz // 16 <= 32
    assert geo["blocks"] == bs * -(-nq // qt) * geo["chunks"]
    if passes == 1:
        cap = knobs.get("MSDA_TAPS_PER_BLOCK") // (heads * lpp)  # spread over blocks where it can
        min_blocks = knobs.get("MSDA_BLOCKS_PER_SM") * SMS
        assert qt == max(1, min(nq, cap, -(-bs * nq // min_blocks)))
    rpw, seg, warps = geo["rows_per_warp"], geo["seg"], 256 // 32
    assert rpw * geo["lanes_per_row"] <= 32 < 2 * rpw * geo["lanes_per_row"]
    assert seg & (seg - 1) == 0 and 1 <= seg <= rpw
    assert rpw // seg * warps <= qt * heads or seg == rpw  # every warp has an output
    assert seg == 1 or rpw // (seg // 2) * warps > qt * heads  # and no more shares than that


@pytest.mark.parametrize("ptr", [0, 8, 4])
@pytest.mark.parametrize("esz", [4, 2, 1])
@pytest.mark.parametrize("name", sorted(msda_specs()))
def test_msda_geometry_keeps_its_one_pass_launch(name, esz, ptr):
    """Every shape that one pass and one chunk took before keeps exactly
    the launch it had, so the models' times do not move."""
    bs, shapes, nq, P, ch, heads = msda_specs()[name]
    old = one_pass_msda_geometry(bs, nq, heads, ch, len(shapes), P, esz, ptr)
    geo = msda_ops.msda_launch_geometry(bs, nq, heads, ch, len(shapes), P, esz, ptr)
    if old is None:  # taps past a block, rows past 128 channels, heads x taps past smem
        assert name in ("lp320", "ch256", "heads64")
        assert geo["passes"] > 1 or geo["chunks"] > 1
        return
    assert {k: geo[k] for k in old} == old
    assert (geo["passes"], geo["chunks"], geo["cch"]) == (1, 1, ch)


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
    (32, 2, 4, 4), (128, 4, 0, 16), (200, 4, 0, 16), (136, 2, 0, 16), (132, 2, 0, 8),
])
def test_msda_geometry_narrows_the_row_loads(ch, esz, ptr, vw):
    geo = msda_ops.msda_launch_geometry(2, 50, 4, ch, 1, 4, esz, ptr)
    assert geo["vw"] == vw and geo["lanes_per_row"] * vw == geo["cch"] * esz
    tail = ch - (geo["chunks"] - 1) * geo["cch"]  # the last chunk's rows take vw too
    assert (tail * esz) % vw == 0


@pytest.mark.parametrize("heads,ch,L,P,match", [
    (8, 32, 1, 257, "taps"), (8, 129, 1, 4, "ch"), (64, 32, 4, 64, "shared memory"),
])
def test_msda_geometry_refuses_what_the_kernel_does_not_take(heads, ch, L, P, match):
    """The three problems one pass and one chunk refused, more than 256 taps
    a head, more than 128 channels and heads x taps past a block's shared
    memory, now launch in passes and chunks that fit; only an empty problem
    is refused."""
    geo = msda_ops.msda_launch_geometry(1, 10, heads, ch, L, P, 4)
    assert geo["smem"] <= msda_ops.SMEM_LIMIT
    if match == "taps":
        assert (geo["lpp"], geo["passes"]) == (256, 2)
    elif match == "ch":
        assert (geo["cch"], geo["chunks"], geo["passes"]) == (128, 2, 1)
    else:  # 64 heads x 256 taps: qt 1, then 64 taps a pass
        assert (geo["qt"], geo["lpp"], geo["passes"]) == (1, 64, 4)
    for empty in ((heads, 0, L, P), (heads, ch, L, 0), (0, ch, L, P)):
        with pytest.raises(ValueError, match="empty"):
            msda_ops.msda_launch_geometry(1, 10, empty[0], empty[1], empty[2], empty[3], 4)


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


# ---- flash attention ---------------------------------------------------------

FLASH_CASES = sorted({(name, kind, d)
                      for name in kc.FLASH_SHAPES
                      for kind in attn_ops.FLASH_KINDS
                      for d in (attn_ops.INT8_FLASH_HEAD_DIMS if kind == "int8"
                                else attn_ops.FLASH_HEAD_DIMS)})


@pytest.mark.parametrize("Lq_extra", [0, 1, 15, 17])
@pytest.mark.parametrize("name,kind,d", FLASH_CASES)
def test_flash_geometry_fits_and_covers_every_row(name, kind, d, Lq_extra):
    """At every shape the wrappers take (and at ragged query lengths), at
    every head dim of its kind: shared memory within a block's limit and two
    blocks an SM where the grid needs them, every query row in one block
    and one warp's 16 rows, at least one block per SM where the shape has
    the rows for it."""
    B, Lq, Lk = kc.FLASH_SHAPES[name][:3]
    Lq += Lq_extra
    geo = attn_ops.flash_launch_geometry(B, Lq, Lk, d, kind)
    gx, gy = geo["grid"]
    rows = geo["rows_per_warp"] * geo["warps"]
    assert gy == B and geo["rows_per_warp"] == 16 and geo["splits"] == 4
    assert geo["threads"] == 32 * geo["warps"] * geo["splits"] <= 1024
    assert (gx - 1) * rows < Lq <= gx * rows  # each row once, no empty block
    assert geo["smem"] == attn_ops.flash_smem_bytes(d, kind, geo["warps"]) <= attn_ops.SMEM_LIMIT
    assert geo["kv_tile"] == (256 if kind == "int8" else 64)
    if gx * gy > SMS:  # the grid needs more than one block an SM
        assert 2 * (geo["smem"] + 1024) <= SM_SMEM or (kind, d) == ("int8", 64)
    if -(-Lq // 16) * B >= SMS:
        assert gx * gy >= SMS
    if geo["warps"] < 4:  # a larger block would leave SMs without one
        assert -(-Lq // (16 * 2 * geo["warps"])) * B < SMS


def test_flash_geometry_at_the_decoder():
    """The decoder's self-attention (8 heads, 900 queries): 2 row groups of
    4 warps, 232 blocks, none of the 132 SMs idle."""
    for kind in attn_ops.FLASH_KINDS:
        geo = attn_ops.flash_launch_geometry(8, 900, 900, 32, kind)
        assert geo["grid"] == (29, 8) and geo["warps"] == 2 and geo["threads"] == 256
    assert attn_ops.flash_launch_geometry(1, 33, 40, 8, "bfloat16")["warps"] == 1
    for kind, d in (("int8", 64), ("float32", 64), ("bfloat16", 8)):  # the bench's row groups
        for w in attn_ops.WARP_CHOICES:
            geo = attn_ops.flash_launch_geometry(8, 900, 900, d, kind, warps=w)
            assert geo["warps"] == w and geo["grid"] == (-(-900 // (16 * w)), 8)
            assert geo["smem"] == attn_ops.flash_smem_bytes(d, kind, w) <= attn_ops.SMEM_LIMIT
    for kind, d in (("int8", 8), ("float32", 48), ("fp16", 32)):
        with pytest.raises(ValueError, match="head dims"):
            attn_ops.flash_launch_geometry(8, 900, 900, d, kind)
    with pytest.raises(ValueError, match="empty"):
        attn_ops.flash_launch_geometry(8, 0, 900, 32, "int8")


def tf32_round(x):
    """cvt.rna.tf32.f32 on the bits: to nearest, ties away from zero, 10
    explicit mantissa bits."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x):
    """The kernel's split (csrc/mma_sync.cuh::tf32_split): big = x cut to
    TF32, small = rna(x - big)."""
    x = x.astype(np.float32)
    big = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return big, tf32_round(x - big)


def split_product(a, b):
    """a @ b as the float32 kernel runs it: big.big + big.small + small.big
    of TF32 terms, float32 sums (a product of two TF32 values is exact in
    float32)."""
    (ab, asm), (bb, bsm) = tf32_split(a), tf32_split(b)
    return (ab @ bsm + asm @ bb) + ab @ bb


def attention_f32(q, k, v, product):
    s = product(q, np.swapaxes(k, 1, 2)) / np.float32(np.sqrt(q.shape[-1]))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    return product(p, v) / p.sum(-1, keepdims=True)


def test_split_tf32_holds_the_float32_bar_and_one_term_does_not():
    """A numpy model of the float32 kernel's products over the decoder shape
    (8 x 900 x 900, d 32): split TF32 within 3e-6 of float64 attention (the
    card's bar against the plain version is 1e-5), one TF32 term far outside
    1e-5."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((8, 900, 32)).astype(np.float32) for _ in range(3))
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v.astype(np.float64))

    def rel(got):
        return float(np.abs(got - want).max() / np.abs(want).max())

    split = rel(attention_f32(q, k, v, split_product))
    one = rel(attention_f32(q, k, v, lambda a, b: tf32_round(a) @ tf32_round(b)))
    assert split < 3e-6 and one > 1e-5, (split, one)


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) on uint32 arrays."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 0x7] << (8 * i) for i in range(4))


def mma_s8(a, b):
    """mma.m16n8k32 s8 on the fragments of csrc/mma_sync.cuh: a [32 lanes,
    4 words], b [32 lanes, 2 words] -> C [16, 8] int32."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)

    def s8(word, j):  # byte j of a word, as a signed int8
        x = word >> (8 * j) & 0xFF
        return x - 256 if x > 127 else x

    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(4):
            A[g, 4 * t + j] = s8(a[lane][0], j)
            A[g + 8, 4 * t + j] = s8(a[lane][1], j)
            A[g, 16 + 4 * t + j] = s8(a[lane][2], j)
            A[g + 8, 16 + 4 * t + j] = s8(a[lane][3], j)
            B[4 * t + j, g] = s8(b[lane][0], j)
            B[16 + 4 * t + j, g] = s8(b[lane][1], j)
    return A @ B


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_key_permutation_gives_the_plain_product(seed):
    """A numpy model of the int8 kernel's P.V over one 256-key block: p8
    packed from the accumulator fragments of q8 k8^T (keys 2t, 2t + 1 of
    each 8-key tile) into A fragments, v8 transposed into [d][keys] with the
    kernel's byte permutes, and the m16n8k32 steps: the int32 product equals
    p8 @ v8 exactly."""
    rng = np.random.default_rng(seed)
    d = 32
    p8 = rng.integers(0, 128, (16, 256)).astype(np.int64)
    v8 = rng.integers(-127, 128, (256, d)).astype(np.int64)
    vbytes = (v8 & 0xFF).astype(np.uint64)
    words = [[int(sum(vbytes[key, 4 * c4 + i] << (8 * i) for i in range(4)))
              for c4 in range(d // 4)] for key in range(256)]  # v rows as stored
    vt = np.zeros((d, 256), np.int64)  # the transposed, permuted block as bytes
    for c4 in range(d // 4):
        for w in range(64):
            base, u = (w // 4) * 16, w % 4
            r0, r1, r2, r3 = (words[key][c4] for key in (base + 2 * u, base + 2 * u + 1,
                                                           base + 8 + 2 * u, base + 9 + 2 * u))
            lo01, hi01 = byte_perm(r0, r1, 0x5140), byte_perm(r0, r1, 0x7362)
            lo23, hi23 = byte_perm(r2, r3, 0x5140), byte_perm(r2, r3, 0x7362)
            for i, word in enumerate((byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
                                      byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632))):
                for j in range(4):
                    vt[4 * c4 + i, 4 * w + j] = word >> (8 * j) & 0xFF
    got = np.zeros((16, d), np.int64)
    for st in range(256 // 32):
        # the accumulator fragments of the four 8-key tiles of this step:
        # c[u][0, 1] = (row g, keys 8u + 2t, + 1), c[u][2, 3] the same at row g + 8
        a = []
        for lane in range(32):
            g, t = lane // 4, lane % 4
            c = [[p8[r, st * 32 + 8 * u + 2 * t + e] for r in (g, g + 8) for e in (0, 1)]
                 for u in range(4)]
            c = [[c[u][0], c[u][1], c[u][2], c[u][3]] for u in range(4)]
            pack = lambda x0, x1, x2, x3: int(x0 | x1 << 8 | x2 << 16 | x3 << 24)
            a.append([pack(c[0][0], c[0][1], c[1][0], c[1][1]), pack(c[0][2], c[0][3], c[1][2], c[1][3]),
                      pack(c[2][0], c[2][1], c[3][0], c[3][1]), pack(c[2][2], c[2][3], c[3][2], c[3][3])])
        for n in range(d // 8):
            b = []
            for lane in range(32):
                g, t = lane // 4, lane % 4
                row = vt[n * 8 + g]
                b.append([int(sum(int(row[st * 32 + 4 * t + j]) << (8 * j) for j in range(4))),
                          int(sum(int(row[st * 32 + 16 + 4 * t + j]) << (8 * j) for j in range(4)))])
            got[:, n * 8:n * 8 + 8] += mma_s8(a, b)
    np.testing.assert_array_equal(got, p8 @ v8)
