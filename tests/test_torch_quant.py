"""The PyTorch port's quantization against the JAX package's (CPU, float32).

Primitives, observers and the scale choice against the JAX functions (exact
or 1e-6); `QDense` / `QConv` in all three modes against flax with carried
"quant" collections (QDQ: 1e-5; int8: 1e-5 of max |out|, the integer sums
being exact); the plain versions of the three int8 kernels against the
Pallas kernels in interpret mode; the policy against the JAX package's; the
QDQ site's modes, folding, and the weights conversion of a "quant"
collection.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.models.layers import QConv as JaxQConv
from bevformer_tensorrt_tpu.models.layers import QDense as JaxQDense
from bevformer_tensorrt_tpu.ops import multi_scale_deformable_attn_sorted as jax_msda_sorted
from bevformer_tensorrt_tpu.ops.pallas.flash_attn import flash_attention_int8 as jax_flash_int8
from bevformer_tensorrt_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from bevformer_tensorrt_tpu.ops.pallas.int8_matmul import int8_matmul_reference
from bevformer_tensorrt_tpu.quant import fold as jax_fold
from bevformer_tensorrt_tpu.quant import observers as jax_obs
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense, int8_im2col
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.quant import observers as obs
from bevformer_tensorrt_tpu_torch.quant import policy
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales, fold_int8_weights
from bevformer_tensorrt_tpu_torch.quant.qdq import QDQ
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import amax_to_quant, random_variables, rel

torch.set_num_threads(2)

# the packages export a function `fake_quant` that shadows the module's name
jax_fq = importlib.import_module("bevformer_tensorrt_tpu.quant.fake_quant")
fq = importlib.import_module("bevformer_tensorrt_tpu_torch.quant.fake_quant")


# ---- (a) primitives and observers -------------------------------------------

def test_quantize_dequantize_fake_quant_match_jax(rng):
    x = (rng.standard_normal((37, 19)) * 3).astype(np.float32)
    x[0, :4] = [0.05, 0.15, -0.25, 1e4]  # exact halves of the grid, and a clipped value
    scale = np.float32(0.1)
    q = fq.quantize(torch.from_numpy(x), float(scale))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_fq.quantize(x, scale)))
    np.testing.assert_array_equal(fq.dequantize(q, float(scale)).numpy(),
                                  np.asarray(jax_fq.dequantize(np.asarray(q), scale)))
    np.testing.assert_array_equal(fq.fake_quant(torch.from_numpy(x), float(scale)).numpy(),
                                  np.asarray(jax_fq.fake_quant(x, scale)))


def test_fake_quant_ste_gradient_matches_jax(rng):
    x = (rng.standard_normal(64) * 8).astype(np.float32)
    x[:3] = [0.1, -12.7, 200.0]  # inside, on the edge of, and outside the clip range
    scale = np.float32(0.1)
    want = jax.grad(lambda t: jnp.sum(jax_fq.fake_quant(t, scale) * jnp.arange(64.0)))(x)
    t = torch.from_numpy(x).requires_grad_()
    (fq.fake_quant(t, torch.tensor(0.1)) * torch.arange(64.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert t.grad[2] == 0 and t.grad[0] == 0.0 * 1 + 0  # index 0 weighs 0; index 2 clips
    assert t.grad[1] == 1.0


@pytest.mark.parametrize("shape,axis", [((8, 3, 3, 4), 0), ((5, 7), 1), ((3, 3, 4, 6), 3)])
def test_per_channel_scale_matches_jax(rng, shape, axis):
    w = rng.standard_normal(shape).astype(np.float32)
    w[(0,) * len(shape)] = 0.0
    got = fq.per_channel_scale(torch.from_numpy(w), axis=axis)
    want = np.asarray(jax_fq.per_channel_scale(w, axis=axis))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_update_amax_and_histogram_match_jax(rng):
    xs = [(rng.standard_normal((3, 500)) * s).astype(np.float32) for s in (1.0, 4.0, 0.3)]
    amax_t, amax_j = torch.zeros(()), jnp.zeros(())
    for x in xs:
        amax_t = obs.update_amax(amax_t, torch.from_numpy(x))
        amax_j = jax_obs.update_amax(amax_j, x)
    assert float(amax_t) == float(amax_j)
    hist_t, hist_j = torch.zeros(obs.NUM_BINS), jnp.zeros(jax_obs.NUM_BINS)
    for x in xs:
        hist_t = obs.update_histogram(hist_t, torch.from_numpy(x), amax_t)
        hist_j = jax_obs.update_histogram(hist_j, x, amax_j)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    assert float(hist_t.sum()) == 1500 * 3


def heavy_tailed_hist(rng):
    x = np.abs(np.concatenate([rng.standard_normal(200000), rng.standard_normal(200) * 12]))
    hist, _ = np.histogram(x, bins=obs.NUM_BINS, range=(0, x.max()))
    return hist.astype(np.float64), float(x.max())


def test_entropy_threshold_matches_jax(rng):
    hist, _ = heavy_tailed_hist(rng)
    assert obs.NUM_BINS == jax_obs.NUM_BINS == 2048
    got = obs.entropy_threshold(hist)
    assert got == jax_obs.entropy_threshold(hist)
    assert 128 <= got < obs.NUM_BINS  # the tail is clipped
    assert obs.entropy_threshold(np.zeros(obs.NUM_BINS)) == obs.NUM_BINS


@pytest.mark.parametrize("method", ["max", "percentile", "entropy"])
def test_compute_scale_matches_jax(rng, method):
    hist, amax = heavy_tailed_hist(rng)
    assert obs.compute_scale(amax, hist, method=method) == pytest.approx(
        jax_obs.compute_scale(amax, hist, method=method), rel=1e-12)
    assert obs.compute_scale(0.0, hist, method=method) == 1.0
    assert obs.compute_scale(amax, None, method=method) == amax / 127.0


def test_compute_scale_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown calibration method"):
        obs.compute_scale(1.0, np.ones(obs.NUM_BINS), method="median")


def test_calibration_result_npz_is_interchangeable(tmp_path):
    res = obs.CalibrationResult({"a/qdq_in": 0.125, "b/c/qdq_residual": 3.5}, "entropy")
    path = str(tmp_path / "scales.npz")
    res.save(path)
    back, jax_back = obs.CalibrationResult.load(path), jax_obs.CalibrationResult.load(path)
    assert back.scales == res.scales == jax_back.scales
    assert back.method == jax_back.method == "entropy"
    jpath = str(tmp_path / "jax_scales.npz")
    jax_obs.CalibrationResult(res.scales, "max").save(jpath)
    assert obs.CalibrationResult.load(jpath).scales == res.scales


# ---- (f) the policy ---------------------------------------------------------

POLICY_SITES = [
    ("pts_bbox_head", "transformer", "encoder", "layer0", "self_attn", "msda_tables"),
    ("pts_bbox_head", "transformer", "encoder", "layer0", "cross_attn", "deformable_attention",
     "msda_tables"),
    ("pts_bbox_head", "transformer", "decoder", "layer1", "self_attn", "flash"),
    ("pts_bbox_head", "transformer", "decoder", "layer1", "self_attn", "q_proj"),
    ("pts_bbox_head", "transformer", "decoder", "layer1", "self_attn", "q_proj", "qdq_in"),
    ("img_backbone", "stage2_block0", "conv2", "dcn_tables"),
    ("img_backbone", "stem_conv"),
    ("img_neck", "fpn0", "qdq_in"),
]


@pytest.mark.parametrize("patterns", [
    (), ("self_attn/msda_tables",), ("msda_tables", "flash"), ("*decoder*q_proj",),
    ("img_backbone/*", "dcn_tables"), ("layer1",), ("img_neck/fpn?/qdq_in",),
])
def test_policy_excludes_the_same_sites_as_jax(patterns):
    jax_policy.set_quant_exclude(patterns)
    try:
        for site in POLICY_SITES:
            assert policy.quant_excluded(site, patterns) == jax_policy.quant_excluded(site), site
            for quant in (False, True, "int8"):
                assert (policy.effective_quant(quant, site, patterns)
                        == jax_policy.effective_quant(quant, site)), (site, quant)
    finally:
        jax_policy.set_quant_exclude(())


def test_policy_sidecar_round_trip(tmp_path):
    art = str(tmp_path / "scales.npz")
    assert policy.load_policy(art) == ()
    policy.save_policy(art, ("self_attn/msda_tables", "dcn_tables"), method="max")
    assert policy.load_policy(art) == ("self_attn/msda_tables", "dcn_tables")
    assert jax_policy.load_policy(art) == policy.load_policy(art)


def test_set_quant_exclude_resolves_sites_once():
    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.keep = QDense(4, 4, quant="int8")
            self.drop = QDense(4, 4, quant="int8")

    m = Pair()
    policy.set_quant_exclude(m, ("drop",))
    assert m.keep.mode == "int8" and m.keep.path == ("keep",)
    assert m.drop.mode is False and m.drop.qdq_in.mode == "off"
    x = torch.randn(2, 4)
    assert torch.equal(m.drop(x), torch.nn.functional.linear(x, m.drop.weight, m.drop.bias))
    with pytest.raises(ValueError, match="calibrated activation scales"):
        m.keep(x)


# ---- the QDQ site -----------------------------------------------------------

def test_qdq_modes(rng):
    x = torch.from_numpy((rng.standard_normal((4, 50)) * 2).astype(np.float32))
    site = QDQ()
    y, s = site(x)  # "quant" without a scale: the identity
    assert y is x and s is None and "scale" not in site.state_dict()
    site.set_mode("amax")
    site(x), site(x * 0.5)
    assert float(site.amax) == float(x.abs().max())
    site.set_mode("hist")
    y, s = site(x)
    assert y is x and s is None and float(site.hist.sum()) == x.numel()
    site.set_mode("quant")
    attach_quant_scales(site, {"": float(site.amax) / 127.0})
    y, s = site(x)
    assert torch.equal(y, fq.fake_quant(x, s)) and list(site.state_dict()) == ["scale"]
    site.set_mode("amax")
    assert float(site.amax) == 0.0  # entering a pass clears its statistic
    with pytest.raises(ValueError, match="mode"):
        site.set_mode("calib")
    off = QDQ()
    off.resolve_quant(("layer", "qdq_in"), ("layer",))  # excluded by the policy
    off.set_mode("amax")
    assert off.mode == "off" and off(x)[0] is x and float(off.amax) == 0.0
    clone = QDQ()
    clone.load_state_dict(site.state_dict())  # the scale comes into being on load
    assert float(clone.scale) == float(site.scale)


def test_attach_quant_scales_rejects_unknown_sites():
    m = QDense(4, 4, quant=True)
    with pytest.raises(KeyError, match="no such QDQ sites"):
        attach_quant_scales(m, {"qdq_out": 0.1})


# ---- (b) QDense and QConv ---------------------------------------------------

MODES = [(False, False), (True, False), ("int8", False), ("int8", True)]  # (quant, folded)


def calibrated(jax_module, rng, x):
    """Seeded flax variables of a quantized layer plus the "quant" collection
    of a one-batch max calibration."""
    variables = random_variables(jax_module, rng, x)
    if jax_module.quant:
        _, mut = jax_module.apply(variables, x, mutable=["amax_stats"])
        variables = {**variables, "quant": amax_to_quant(mut["amax_stats"])}
    return variables


@pytest.mark.parametrize("quant,folded", MODES)
@pytest.mark.parametrize("K,N,bias", [(64, 32, True), (18, 32, True), (64, 3, True),
                                      (147, 27, False)])
def test_qdense_matches_flax(rng, quant, folded, K, N, bias):
    x = (rng.standard_normal((2, 9, K)) * 2).astype(np.float32)
    jm = JaxQDense(N, use_bias=bias, quant=quant)
    variables = calibrated(jm, rng, x)
    if folded:
        variables = jax.tree_util.tree_map(np.asarray, jax_fold.fold_int8_weights(variables))
    want = np.asarray(jm.apply(variables, x))
    m = QDense(K, N, bias=bias, quant=quant)
    m.load_state_dict(params_from_jax(variables), strict=True)
    assert (m.wq is not None) == folded
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert rel(got, want) < 1e-5, (quant, folded)


@pytest.mark.parametrize("quant,folded", MODES)
@pytest.mark.parametrize("cin,cout,k,stride,pad,bias", [
    (16, 8, 1, 1, 0, False), (16, 8, 1, 2, 0, True), (8, 12, 3, 1, 1, True),
    (8, 27, 3, 2, 1, True), (3, 16, 7, 2, 3, False),
])
def test_qconv_matches_flax(rng, quant, folded, cin, cout, k, stride, pad, bias):
    x = (rng.standard_normal((2, cin, 13, 18)) * 2).astype(np.float32)
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    jm = JaxQConv(cout, (k, k), (stride, stride), padding=pad, use_bias=bias, quant=quant)
    variables = calibrated(jm, rng, nhwc)
    if folded:
        variables = jax.tree_util.tree_map(np.asarray, jax_fold.fold_int8_weights(variables))
    want = np.asarray(jm.apply(variables, nhwc)).transpose(0, 3, 1, 2)
    m = QConv(cin, cout, k, stride, pad, bias=bias, quant=quant)
    m.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) < 1e-5, (quant, folded)


def test_int8_without_scales_raises_outside_calibration(rng):
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    for m in (QDense(16, 4, quant="int8"), QConv(8, 4, 3, 1, 1, quant="int8")):
        inp = x if isinstance(m, QDense) else x.reshape(2, 8, 4, 4)
        with pytest.raises(ValueError, match="calibrated activation scales"):
            m(inp)
        m.qdq_in.set_mode("amax")  # a calibration pass: allowed, weights fake-quantized
        m(inp)
        m.qdq_in.set_mode("quant")
        attach_quant_scales(m, {"qdq_in": float(m.qdq_in.amax) / 127.0})
        assert torch.isfinite(m(inp)).all()


def test_fold_matches_derived_and_refolds_from_current_weights(rng):
    x = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    m = QDense(24, 8, quant="int8")
    m.qdq_in.scale = torch.tensor(0.03)
    derived = m(x)
    fold_int8_weights(m)
    assert m.wq.dtype == torch.int8 and tuple(m.wq.shape) == (8, 24)
    assert tuple(m.wscale.shape) == (8,)
    assert torch.equal(m(x), derived)
    fold_int8_weights(m)  # idempotent
    assert torch.equal(m(x), derived)
    with torch.no_grad():
        m.weight.mul_(2.0)
    assert torch.equal(m(x), derived)  # the folded pair is what runs
    attach_quant_scales(m, {"qdq_in": 0.03})  # re-folds from the current weights
    assert rel(m(x).detach().numpy(), (2 * derived - m.bias).detach().numpy()) < 1e-6
    plain = QDense(24, 8, quant="int8")  # no scale: left untouched
    assert fold_int8_weights(plain).wq is None


def test_int8_im2col_matches_unfold(rng):
    x = torch.from_numpy(rng.integers(-127, 128, (2, 5, 9, 11)).astype(np.int8))
    for k, s, p in ((3, 1, 1), (3, 2, 1), (7, 2, 3), (1, 2, 0)):
        col, Ho, Wo = int8_im2col(x, (k, k), (s, s), (p, p), k_align=16)
        K = k * k * 5
        assert col.dtype == torch.int8 and col.shape == (2 * Ho * Wo, -(-K // 16) * 16)
        assert not col[:, K:].any()
        want = torch.nn.functional.unfold(x.float(), k, padding=p, stride=s)  # [N, C*k*k, L]
        want = want.reshape(2, 5, k * k, Ho * Wo).permute(0, 3, 2, 1).reshape(-1, K)
        assert torch.equal(col[:, :K].float(), want)


def test_weights_reject_other_quant_leaves(rng):
    base = {"params": {"kernel": np.ones((4, 3), np.float32)}}
    with pytest.raises(KeyError, match="zero_point"):
        params_from_jax({**base, "quant": {"qdq_in": {"zero_point": np.float32(0)}}})
    with pytest.raises(KeyError, match="wq"):
        params_from_jax({**base, "quant": {"wq": np.ones((4, 3), np.float32)}})
    with pytest.raises(KeyError, match="amax_stats"):
        params_from_jax({**base, "amax_stats": {}})
    sd = params_from_jax({**base, "quant": {"wq": np.ones((4, 3), np.int8),
                                            "wscale": np.ones(3, np.float32),
                                            "qdq_in": {"scale": np.float32(0.5)}}})
    assert sd["wq"].dtype == torch.int8 and tuple(sd["wq"].shape) == (3, 4)
    assert float(sd["qdq_in.scale"]) == 0.5


# ---- (c) the int8 product ---------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(70, 256, 48), (1, 18, 128), (33, 147, 64), (50, 64, 3),
                                   (40, 4608, 27)])
def test_int8_matmul_plain_matches_pallas_and_reference(rng, M, K, N):
    """Exact int32 sums, so the three agree to the float32 rounding of the
    dequantization (1e-6 relative).  K = 4608 with full-range operands
    passes 2^24, where a float32 product would no longer be exact."""
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    if K == 4608:
        x[0], w[:, 0] = 127, 127  # one sum of 4608 * 127^2 = 7.4e7
    xs = np.float32(0.0173)
    ws = rng.uniform(0.001, 0.02, N).astype(np.float32)
    got = int8_ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                               torch.tensor(xs), torch.from_numpy(ws)).numpy()
    ref = np.asarray(int8_matmul_reference(x, w, xs, ws))
    pallas = np.asarray(jax_int8_matmul(x, w, jnp.float32(xs), ws, block_m=128, block_n=128,
                                        block_k=256, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
    if K == 4608:
        assert got[0, 0] == pytest.approx(4608 * 127 * 127 * float(xs) * float(ws[0]), rel=1e-6)
    bf16 = int8_ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                                float(xs), torch.from_numpy(ws), out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and rel(bf16.float().numpy(), ref) < 1e-2


# ---- (d) int8 flash attention -----------------------------------------------

@pytest.mark.parametrize("B,Lq,Lk,d", [(2, 256, 512, 32), (3, 100, 300, 32), (2, 77, 900, 64)])
def test_flash_int8_plain_matches_pallas_interpret(rng, B, Lq, Lk, d):
    """Same quantization, same 256-key requantization blocks.  The integer
    products are exact; the two can differ where `exp` differs in its last
    bit and that flips a `round(p * 127)`.  Measured 1e-7 to 7e-7 of
    max |out| (no flip); bar 1e-4 (another block size is off by 1e-2)."""
    q, k, v = (rng.standard_normal((B, n, d)).astype(np.float32) for n in (Lq, Lk, Lk))
    want = np.asarray(jax_flash_int8(q, k, v, block_q=64, block_k=256, interpret=True))
    got = attn_ops.flash_attention_int8(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert got.shape == want.shape
    assert rel(got, want) < 1e-4
    exact = attn_ops.qkv_plain(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert 1e-4 < rel(got, exact) < 0.15  # it is the int8 function, not the float one


def test_flash_int8_block_size_is_part_of_the_contract(rng):
    q, k, v = (rng.standard_normal((2, 64, 32)).astype(np.float32) for _ in range(3))
    # 512 keys, two blocks; the logits grow along the keys, so the running
    # maximum that p is rounded against depends on where a block ends
    k = np.concatenate([k * 0.5, k * 0.7, k, k * 1.5] * 2, axis=1)
    v = np.tile(v, (1, 8, 1))
    other = np.asarray(jax_flash_int8(q, k, v, block_q=64, block_k=128, interpret=True))
    same = np.asarray(jax_flash_int8(q, k, v, block_q=64, block_k=256, interpret=True))
    got = attn_ops.flash_attention_int8_plain(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert attn_ops.INT8_BLOCK_K == 256
    assert rel(got, same) < 1e-4 < rel(got, other)


def test_multi_head_attention_int8_splits_heads(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 128)).astype(np.float32))
               for _ in range(3))
    got = attn_ops.multi_head_attention(q, k, v, num_heads=4, int8=True)
    heads = [t.reshape(1, 40, 4, 32).transpose(1, 2).reshape(4, 40, 32) for t in (q, k, v)]
    want = attn_ops.flash_attention_int8_plain(*heads)
    assert torch.equal(got, want.reshape(1, 4, 40, 32).transpose(1, 2).reshape(1, 40, 128))


# ---- (e) int8 value tables --------------------------------------------------

def msda_inputs(rng, shapes, bs, nq, heads, ch, P, ppg):
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    value = (rng.standard_normal((bs, keys, heads, ch)) * rng.uniform(
        0.2, 3.0, (bs, 1, heads, 1))).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (bs, nq, 1, 2 * ppg)).astype(np.float32)
    off = (rng.standard_normal((bs, nq, heads, L * P * 2)) * 3).astype(np.float32)
    attn = rng.standard_normal((bs, nq, heads, L * P)).astype(np.float32)
    return value, ref, off, attn


MSDA_INT8_CASES = {
    "L1_ppg1": (((10, 12),), 2, 40, 4, 8, 4, 1),
    "L1_ppg4": (((10, 12),), 3, 40, 4, 32, 8, 4),
    "L4_ppg4": (((16, 20), (8, 10), (4, 5), (2, 3)), 2, 30, 2, 8, 8, 4),
}


@pytest.mark.parametrize("case", sorted(MSDA_INT8_CASES))
def test_msda_int8_plain_is_the_float_path_on_the_dequantized_value(rng, case):
    shapes, *dims = MSDA_INT8_CASES[case]
    value, ref, off, attn = (torch.from_numpy(t) for t in msda_inputs(rng, shapes, *dims))
    q, scale = msda_ops.quantize_value_table(value)
    assert q.dtype == torch.int8 and tuple(scale.shape) == (dims[0], dims[2])
    np.testing.assert_allclose(scale.numpy(), value.abs().amax(dim=(1, 3)).numpy() / 127.0,
                               rtol=1e-7)
    assert int(q.abs().max()) == 127
    deq = q.float() * scale[:, None, :, None]
    want = msda_ops.multi_scale_deformable_attn(deq, ref, off, attn, shapes)
    got = msda_ops.multi_scale_deformable_attn_int8(value, ref, off, attn, shapes)
    assert rel(got.numpy(), want.numpy()) < 1e-5
    full = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, shapes)
    assert 1e-4 < rel(got.numpy(), full.numpy()) < 2e-2  # int8 tables are in use


@pytest.mark.parametrize("case", sorted(MSDA_INT8_CASES))
def test_msda_int8_plain_matches_pallas_interpret(rng, case):
    """The TPU kernel with `packed="int8"` in interpret mode: the same int8
    values and scales, but its combined weights are rounded to bfloat16
    (2^-9 relative each) and the port's stay float32.  Bar: 2^-8 of
    max |out|."""
    shapes, *dims = MSDA_INT8_CASES[case]
    value, ref, off, attn = msda_inputs(rng, shapes, *dims)
    want = np.asarray(jax_msda_sorted(value, ref, off, attn, shapes, packed="int8",
                                      interpret=True))
    got = msda_ops.multi_scale_deformable_attn_int8(
        *(torch.from_numpy(t) for t in (value, ref, off, attn)), shapes).numpy()
    assert rel(got, want) < 2.0 ** -8
