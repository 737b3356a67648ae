"""The PyTorch port's quantized modules and model against the JAX package's
(CPU, float32, micro sizes).

Each flax module is calibrated once (`max`, one batch) and its "quant"
collection carried into the port through `params_from_jax`, so both sides
hold the same scales and, under "int8", the same int8 weights.  The JAX
package reaches neither the int8 value tables nor the int8 flash kernel off
a TPU, so the pseudo-sites `msda_tables` and `flash` are excluded on both
sides; those two kernels' plain versions are held to the Pallas kernels in
tests/test_torch_quant.py.

Tolerances: the integer sums are exact and the rest is float32, so the two
packages agree to 1e-5 per module and 1e-4 end to end wherever no
quantization step rounds the other way.  A value that sits within float32
noise of a rounding boundary can flip and move one activation by a whole
step; the bars below say where that was measured.
"""
import jax
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.models.backbones import resnet as jax_resnet
from bevformer_tensorrt_tpu.models.layers import FFN as JaxFFN
from bevformer_tensorrt_tpu.models.modules import attention as jax_attn
from bevformer_tensorrt_tpu.models.necks.fpn import FPN as JaxFPN
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.quant.calibrate import collect_stats as jax_collect_stats
from bevformer_tensorrt_tpu.quant.calibrate import scales_from_stats as jax_scales_from_stats
from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.configs.bevformer import (
    bevformer_base,
    bevformer_micro,
    bevformer_tiny,
)
from bevformer_tensorrt_tpu_torch.models.backbones import resnet as port_resnet
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.models.layers import FFN
from bevformer_tensorrt_tpu_torch.models.modules import attention as port_attn
from bevformer_tensorrt_tpu_torch.models.necks.fpn import FPN
from bevformer_tensorrt_tpu_torch.quant.calibrate import collect_stats, scales_from_stats
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.quant.observers import NUM_BINS, CalibrationResult
from bevformer_tensorrt_tpu_torch.quant.policy import load_policy, set_quant_exclude
from bevformer_tensorrt_tpu_torch.quant.qdq import QDQ
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import (
    amax_to_quant,
    build_engine_case,
    load_port,
    model_batches,
    random_variables,
    rel,
)

torch.set_num_threads(2)

TOL = 1e-5
C, HEADS = 64, 2  # head width 32: eligible for the int8 flash kernel
OFF_TPU = ("msda_tables", "flash")  # what the JAX package cannot reach on the CPU
QUANTS = [True, "int8"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_quant_pair(jax_module, port_module, rng, *args, nchw=False):
    """Seeded weights, a one-batch `max` calibration on the flax side, the
    scales carried into the port; returns (jax_out, port_out) as numpy (NCHW
    for both when `nchw`: the flax module then sees the maps as NHWC)."""
    jargs = [np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if nchw else a for a in args]
    variables = random_variables(jax_module, rng, *jargs)
    _, mut = jax_module.apply(variables, *jargs, mutable=["amax_stats"])
    variables = {**variables, "quant": amax_to_quant(mut["amax_stats"])}
    want = jax_module.apply(variables, *jargs)
    set_quant_exclude(port_module, OFF_TPU)
    load_port(port_module, variables)
    with torch.no_grad():
        got = port_module(*(t(a) if isinstance(a, np.ndarray) else a for a in args))
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    want = [np.asarray(w).transpose(0, 3, 1, 2) if nchw else np.asarray(w) for w in want]
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("quant", QUANTS)
def test_ffn(quant, rng):
    x = rng.standard_normal((1, 50, C)).astype(np.float32)
    want, got = run_quant_pair(JaxFFN(C, 2 * C, quant=quant), FFN(C, 2 * C, quant=quant), rng, x)
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("quant", QUANTS)
def test_temporal_self_attention(quant, rng):
    bh, bw = 6, 7
    nq = bh * bw
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((2, nq, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    ref = rng.uniform(-0.05, 1.05, (2, nq, 1, 2)).astype(np.float32)
    want, got = run_quant_pair(
        jax_attn.TemporalSelfAttention(embed_dims=C, num_heads=HEADS, num_points=4,
                                       msda_impl="jnp", quant=quant),
        port_attn.TemporalSelfAttention(C, HEADS, 1, 4, quant=quant),
        rng, query, value, query, pos, ref, ((bh, bw),))
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("quant", QUANTS)
def test_spatial_cross_attention(quant, rng):
    cams, ppg, shapes, nq = 3, 4, ((6, 8), (3, 4)), 300  # K 128 < nq: compaction is on
    keys = sum(h * w for h, w in shapes)
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((cams, keys, C)).astype(np.float32)
    ref_cam = rng.uniform(-0.1, 1.1, (cams, nq, ppg * 2)).astype(np.float32)
    mask = rng.choice([0.0, 0.5, 1.0], (cams, nq, 1), p=[0.34, 0.33, 0.33]).astype(np.float32)
    want, got = run_quant_pair(
        jax_attn.SpatialCrossAttention(embed_dims=C, num_cams=cams, num_heads=HEADS,
                                       num_levels=2, num_points=8, cam_budget=0.35,
                                       msda_impl="jnp", quant=quant),
        port_attn.SpatialCrossAttention(C, cams, HEADS, 2, 8, 0.35, quant=quant),
        rng, query, value, query, None, ref_cam, mask, shapes)
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("quant", QUANTS)
def test_decoder_cross_attention(quant, rng):
    bh, bw, nq = 8, 9, 30
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    value = rng.standard_normal((1, bh * bw, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    ref = rng.uniform(-0.05, 1.05, (1, nq, 1, 2)).astype(np.float32)
    want, got = run_quant_pair(
        jax_attn.CustomMSDeformableAttention(embed_dims=C, num_heads=HEADS, num_points=4,
                                             msda_impl="jnp", quant=quant),
        port_attn.CustomMSDeformableAttention(C, HEADS, 1, 4, quant=quant),
        rng, query, value, query, pos, ref, ((bh, bw),))
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("quant", QUANTS)
def test_decoder_self_attention_uses_qdq_qkv_when_flash_is_excluded(quant, rng):
    nq = 45
    query = rng.standard_normal((1, nq, C)).astype(np.float32)
    pos = rng.standard_normal((1, nq, C)).astype(np.float32)
    port = port_attn.MultiheadAttention(C, HEADS, quant=quant)
    assert port.int8_flash == (quant == "int8")  # unresolved: the module's own mode
    want, got = run_quant_pair(jax_attn.MultiheadAttention(embed_dims=C, num_heads=HEADS,
                                                           quant=quant),
                               port, rng, query, query, query, query, pos, pos)
    assert not port.int8_flash and port.qdq_q.scale is not None
    assert rel(got[0], want[0]) < TOL


def test_decoder_self_attention_int8_flash_selection(rng):
    """"int8" with head width 32 selects the int8 flash kernel and switches
    qdq_q/k/v off; width 8 (micro) keeps them and the floating-point kernel."""
    x = t(rng.standard_normal((1, 20, C)).astype(np.float32))
    mha = port_attn.MultiheadAttention(C, HEADS, quant="int8")
    set_quant_exclude(mha, ())
    assert mha.int8_flash and mha.qdq_q.mode == "off"
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        getattr(mha, name).qdq_in.scale = torch.tensor(0.05)
    with torch.no_grad():
        out = mha(x, x, x, None, None, None)
        q, k, v = mha.q_proj(x), mha.k_proj(x), mha.v_proj(x)
        want = mha.out_proj(ops.multi_head_attention(q, k, v, HEADS, int8=True)) + x
    assert torch.equal(out, want)
    narrow = port_attn.MultiheadAttention(C, 8, quant="int8")
    set_quant_exclude(narrow, ())
    assert not narrow.int8_flash and narrow.qdq_q.mode == "quant"


@pytest.mark.parametrize("quant", QUANTS)
def test_bottleneck_with_residual_site(quant, rng):
    x = rng.standard_normal((2, 16, 10, 12)).astype(np.float32)
    want, got = run_quant_pair(
        jax_resnet.Bottleneck(8, (2, 2), downsample=True, style="pytorch", quant=quant),
        port_resnet.Bottleneck(16, 8, 2, True, "pytorch", quant=quant), rng, x, nchw=True)
    assert rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("quant", QUANTS)
def test_fpn(quant, rng):
    maps = [rng.standard_normal((2, c, h, w)).astype(np.float32)
            for c, h, w in ((8, 12, 16), (16, 6, 8), (32, 3, 4))]
    variables_in = [np.ascontiguousarray(m.transpose(0, 2, 3, 1)) for m in maps]
    jm = JaxFPN(out_channels=16, num_outs=4, quant=quant)
    variables = random_variables(jm, rng, variables_in)
    _, mut = jm.apply(variables, variables_in, mutable=["amax_stats"])
    variables = {**variables, "quant": amax_to_quant(mut["amax_stats"])}
    want = jm.apply(variables, variables_in)
    port = load_port(FPN([8, 16, 32], 16, 4, quant=quant), variables)
    with torch.no_grad():
        got = port([t(m) for m in maps])
    for g, w in zip(got, want):
        assert rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) < TOL


def test_dcn_block_under_quant():
    """QDQ simulation runs a DCN block (the op ignores `quant` unless it is
    "int8"); "int8" raises for the int8 gather table unless the policy
    excludes `dcn_tables`."""
    x = torch.randn(1, 8, 6, 7)
    block = port_resnet.DeformConv2d(8, 8, quant=True)
    torch.nn.init.normal_(block.weight, std=0.1)
    assert torch.isfinite(block(x)).all()
    refused = port_resnet.DeformConv2d(8, 8, quant="int8")
    with pytest.raises(NotImplementedError, match="int8 gather table"):
        refused(x)
    with pytest.raises(NotImplementedError, match="dcn_tables"):
        set_quant_exclude(refused, ())
    set_quant_exclude(refused, ("dcn_tables",))
    refused.conv_offset.qdq_in.scale = torch.tensor(0.05)
    torch.nn.init.normal_(refused.weight, std=0.1)
    assert torch.isfinite(refused(x)).all()


# ---- (f) the default policy -------------------------------------------------

def table_sites(model):
    return {name: m.int8_tables for name, m in model.named_modules()
            if hasattr(m, "int8_tables")}


def test_default_int8_policy_leaves_exactly_the_tsa_tables_floating_point():
    assert bevformer_tiny(quant="int8").quant_exclude == ("self_attn/msda_tables",)
    model = BEVFormer(bevformer_micro(quant="int8", num_heads=2))  # head width 32
    sites = table_sites(model)
    assert len(sites) == 6  # 2 TSA + 2 SCA + 2 decoder cross-attention
    for name, int8 in sites.items():
        assert int8 == (not name.endswith("encoder.layer0.self_attn")
                        and not name.endswith("encoder.layer1.self_attn")), name
    for name, m in model.named_modules():
        if hasattr(m, "int8_flash"):
            assert m.int8_flash and m.qdq_q.mode == "off", name
        if hasattr(m, "mode") and not isinstance(m, QDQ):
            assert m.mode == "int8", name  # no dense or conv layer is excluded
    assert all(table_sites(BEVFormer(bevformer_micro(quant="int8", quant_exclude=()))).values())
    assert not any(table_sites(BEVFormer(bevformer_micro(quant=True))).values())


def test_int8_on_a_dcn_backbone_needs_dcn_tables_excluded():
    dcn = dict(dcn_stages=(False, False, True, True))
    with pytest.raises(NotImplementedError, match="int8 gather table"):
        BEVFormer(bevformer_micro(quant="int8", **dcn))
    with pytest.raises(NotImplementedError, match="int8 gather table"):
        BEVFormer(bevformer_base(quant="int8"))
    policy = ("self_attn/msda_tables", "dcn_tables")
    assert BEVFormer(bevformer_micro(quant="int8", quant_exclude=policy, **dcn)) is not None
    assert BEVFormer(bevformer_micro(quant=True, **dcn)) is not None  # QDQ runs DCN


# ---- (g) calibration --------------------------------------------------------

@pytest.fixture(scope="module")
def micro_qdq_case():
    over = (("quant", True), ("quant_exclude", OFF_TPU))
    return build_engine_case("bevformer_micro", over)


@pytest.fixture(scope="module")
def jax_stats(micro_qdq_case):
    cfg, jcfg, model, variables, frames = micro_qdq_case
    fns = {}

    def apply_fn(v, batch, mutable):
        key = tuple(mutable)
        if key not in fns:
            fns[key] = jax.jit(lambda v, *a: model.apply(v, *a, mutable=list(key))[1])
        return fns[key](v, *batch)

    return jax_collect_stats(apply_fn, variables, model_batches(cfg, frames))


@pytest.fixture(scope="module")
def port_stats(micro_qdq_case):
    cfg, jcfg, model, variables, frames = micro_qdq_case
    port = load_port(BEVFormer(cfg), variables)
    with torch.no_grad():
        return collect_stats(lambda b: port(*(t(np.asarray(a)) for a in b)), port,
                             model_batches(cfg, frames))


def test_calibration_sites_match_jax(jax_stats, port_stats):
    want = jax_scales_from_stats(*jax_stats, method="max")[1].scales
    assert sorted(port_stats[0]) == sorted(want) and len(want) == 132
    assert all(h.shape == (NUM_BINS,) for h in port_stats[1].values())


def test_max_calibration_matches_jax(jax_stats, port_stats):
    """`max` scales are abs-maxima of float32 activations up to 50 layers
    deep: they agree to the float32 noise of the forward, 1e-5 relative."""
    want = jax_scales_from_stats(*jax_stats, method="max")[1].scales
    got = scales_from_stats(*port_stats, method="max").scales
    for name, scale in want.items():
        assert got[name] == pytest.approx(scale, rel=1e-5), name


def test_entropy_calibration_matches_jax(jax_stats, port_stats):
    """`entropy` picks a histogram bin; a sample on a bin's edge may fall on
    either side, so the chosen clip may differ by one bin of 2048."""
    want = jax_scales_from_stats(*jax_stats, method="entropy")[1].scales
    got = scales_from_stats(*port_stats, method="entropy").scales
    amax = port_stats[0]
    for name, scale in want.items():
        one_bin = amax[name] / NUM_BINS / 127.0
        assert abs(got[name] - scale) <= one_bin * 1.001 + 1e-5 * scale, name


def test_collect_stats_restores_the_sites(micro_qdq_case, port_stats):
    cfg = micro_qdq_case[0]
    port = BEVFormer(cfg)
    sites = [m for m in port.modules() if isinstance(m, QDQ)]

    def boom(batch):
        raise RuntimeError("batch failed")

    with pytest.raises(RuntimeError, match="batch failed"):
        collect_stats(boom, port, [None])
    assert all(s.mode == "quant" for s in sites)


# ---- (h) the model ----------------------------------------------------------

def rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.parametrize("quant", QUANTS)
def test_backbone_agrees_until_roundings_flip(quant, rng):
    """R50 at micro size with carried scales.  Float32 noise (1e-7) puts a
    few activations on the other side of a rounding boundary, each a whole
    step (1/127 of the range) away: measured, 6e-4 of the first stage's
    outputs differ by more than 1e-4 (max 1e-3 under QDQ, 1.1e-2 under
    int8), and the random-weight stages behind it spread that to 3/4 of the
    last stage's outputs (max 5e-2).  Bars: first stage 2e-2 max (about two
    steps) with under 1% of elements moved; last stage 0.1 max."""
    x = rng.standard_normal((2, 3, 96, 160)).astype(np.float32)
    want, got = run_quant_pair(
        jax_resnet.ResNet(depth=50, out_indices=(0, 3), quant=quant),
        port_resnet.ResNet(50, (0, 3), quant=quant), rng, x, nchw=True)
    moved = np.abs(got[0] - want[0]) > 1e-4 * np.abs(want[0]).max()
    assert rel(got[0], want[0]) < 2e-2 and moved.mean() < 0.01
    assert rel(got[1], want[1]) < 0.1


@pytest.mark.parametrize("quant", QUANTS)
def test_two_frames_match_jax(quant, micro_qdq_case, jax_stats):
    """Micro over two frames (the second temporal) through both engines,
    with the JAX package's `max` scales carried into the port.

    The 1e-4 of the floating-point model tests cannot hold here: rounding flips
    (see test_backbone_agrees_until_roundings_flip) decorrelate the two
    packages' quantization noise, so their outputs differ by about as much
    as either differs from the floating-point model (measured: 1.7-2.6e-2
    rms between the packages, 1.6-3.1e-2 rms of quantization noise).  Held
    instead: the port strays from the JAX package by no more than 1.5 times
    that noise, and its own quantization noise, against the JAX package's
    floating-point outputs, is between half and twice the JAX package's.
    What carries the exact comparison is the module tests above (1e-5 with
    carried scales) and the calibration tests (every site's statistics at
    1e-5 through the whole forward)."""
    from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine

    cfg, jcfg, model, variables, frames = micro_qdq_case
    quant_vars, _ = jax_scales_from_stats(*jax_stats, method="max")
    fp_case = build_engine_case("bevformer_micro", ())
    over = (("quant", quant), ("quant_exclude", OFF_TPU))
    cfg_q, jcfg_q, model_q, _, _ = build_engine_case("bevformer_micro", over)
    q_vars = {**variables, "quant": jax.tree_util.tree_map(np.asarray, quant_vars["quant"])}
    jax_policy.set_quant_exclude(OFF_TPU)
    jax_q = JaxEngine(model_q, q_vars, jcfg_q, donate_prev_bev=False)
    jax_fp = JaxEngine(fp_case[2], variables, fp_case[1], donate_prev_bev=False)
    port = BEVFormerEngine(cfg_q, state_dict=params_from_jax(q_vars), device="cpu")
    for i, f in enumerate(frames):
        want, ref, got = jax_q.infer_frame(**f), jax_fp.infer_frame(**f), port.infer_frame(**f)
        triples = [("bev_embed", port.state.prev_bev, jax_q.state.prev_bev,
                    jax_fp.state.prev_bev),
                   ("classes", got[0], want[0], ref[0]), ("coords", got[1], want[1], ref[1])]
        for name, g, w, r in triples:
            g = g.numpy()
            assert g.shape == np.shape(w) and np.isfinite(g).all(), (quant, i, name)
            noise = rms(r, w)
            assert rms(g, w) < 1.5 * noise, (quant, i, name, rms(g, w), noise)
            assert 0.5 * noise < rms(g, r) < 2.0 * noise, (quant, i, name, rms(g, r), noise)


@pytest.mark.parametrize("exclude", [OFF_TPU, ("self_attn/msda_tables",)],
                         ids=["no_int8_tables_or_flash", "default_policy"])
def test_int8_engine_calibrates_and_tracks_the_qdq_simulation(exclude, rng):
    """The port alone, micro with head width 32 (so the default policy runs
    int8 tables and int8 flash): calibrate the QDQ tier, attach its scales to
    the int8 tier of the same weights, and hold the int8 coordinates to the
    simulation's.  The JAX package's bar for this is a mean difference of
    0.05 (tests/test_quant.py, at its seed); over seeds and policies the
    port measures 0.02-0.06: the two tiers round independently, so they
    differ by a good part of what quantization itself moves the coordinates
    (0.09 here).  Bars: 0.1, and no more than quantization moves them."""
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames

    over = dict(num_heads=2, encoder_layers=1, decoder_layers=1, quant_exclude=exclude)
    cfg = bevformer_micro(quant=True, **over)
    frames = synthetic_frames(cfg, rng, ("a", "a"))
    qdq = BEVFormerEngine(cfg, device="cpu", seed=3)
    result = qdq.calibrate(frames, method="max")
    assert isinstance(result, CalibrationResult) and result.method == "max"
    assert qdq.state.prev_bev is None
    int8 = BEVFormerEngine(bevformer_micro(quant="int8", **over), device="cpu", seed=3)
    with pytest.raises(ValueError, match="calibrated activation scales"):
        int8.infer_frame(**frames[0])
    int8.reset()
    attach_quant_scales(int8.model, result.scales)
    assert int8.model.img_backbone.stem_conv.wq.dtype == torch.int8
    fp = BEVFormerEngine(bevformer_micro(**{k: v for k, v in over.items()
                                            if k != "quant_exclude"}), device="cpu", seed=3)
    ops.reset_launch_counts()
    for f in frames:
        want, got, ref = qdq.infer_frame(**f), int8.infer_frame(**f), fp.infer_frame(**f)
        assert torch.isfinite(got[1]).all()
        drift = float((got[1] - want[1]).abs().mean())
        assert drift < 0.1 and drift < float((want[1] - ref[1]).abs().mean())
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 6  # CPU: plain versions


def test_calibrate_tool_writes_scales_and_policy(tmp_path):
    from bevformer_tensorrt_tpu_torch.tools import calibrate as tool

    out = str(tmp_path / "micro_scales.npz")
    tool.main(["--out", out, "--model", "micro", "--frames", "2", "--method", "max",
               "--device", "cpu"])
    result = CalibrationResult.load(out)
    assert result.method == "max" and len(result.scales) == 132
    assert all(s > 0 for s in result.scales.values())
    assert load_policy(out) == ("self_attn/msda_tables",)
    engine = BEVFormerEngine(bevformer_micro(quant="int8"), device="cpu", seed=0)
    attach_quant_scales(engine.model, result.scales)  # every site of the int8 tier finds its scale
    missing = [n for n, m in engine.model.named_modules()
               if isinstance(m, QDQ) and m.mode != "off" and m.scale is None]
    assert not missing
