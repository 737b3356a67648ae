"""The port's BEVDet detector and its CLIs against the JAX package on the CPU
(micro): the head maps in float32 (both splats), bfloat16, QDQ and int8 with
the same scales, then `tools/bevdet/evaluate.py` against the JAX pipeline on
a generated set and `tools/bevdet/calibrate.py` against the JAX tool's
procedure.  A file of its own: it compiles the JAX micro detector."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from bevformer_tensorrt_tpu.configs.bevdet import bevdet_micro as jax_micro
from bevformer_tensorrt_tpu.models.detectors.bevdet import BEVDet as JaxBEVDet
from bevformer_tensorrt_tpu.models.heads.centerpoint_head import (
    centerpoint_post_process as jax_post_process,
)
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.quant.calibrate import collect_stats as jax_collect_stats
from bevformer_tensorrt_tpu.quant.calibrate import scales_from_stats as jax_scales_from_stats
from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevdet import BEVDet
from bevformer_tensorrt_tpu_torch.models.necks.view_transformer import (
    get_lidar_coor,
    voxel_pooling_prepare,
)
from bevformer_tensorrt_tpu_torch.quant.observers import NUM_BINS, CalibrationResult
from bevformer_tensorrt_tpu_torch.quant.policy import load_policy
from bevformer_tensorrt_tpu_torch.runtime.bevdet_engine import rig_ranks
from bevformer_tensorrt_tpu_torch.runtime.synthetic import bevdet_rig
from bevformer_tensorrt_tpu_torch.runtime.torch_import import bevdet_upstream_layout
from bevformer_tensorrt_tpu_torch.tools.bevdet import calibrate, evaluate
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import (
    SYNTH_INFOS,
    amax_to_quant,
    make_synthetic_set,
    random_variables,
    rel,
)

torch.set_num_threads(2)

HEADS = ("reg", "height", "dim", "rot", "vel", "heatmap")


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.fixture(scope="module")
def case():
    """(ranks args, two images, seeded flax variables) on a surround rig."""
    cfg = bevdet_micro()
    rng = np.random.default_rng(5)
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, rng)
    r = voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=600,
                              pad_intervals_to=cfg.bev_h * cfg.bev_w)
    ranks = (r.ranks_depth, r.ranks_feat, r.ranks_bev, r.interval_starts, r.interval_lengths)
    images = [rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w))
              .astype(np.float32) for _ in range(2)]
    variables = random_variables(JaxBEVDet(jax_micro()), rng, images[0], *ranks)
    return ranks, images, variables


def _jax_heads(jcfg, variables, image, ranks):
    return {k: np.asarray(v).transpose(0, 3, 1, 2)
            for k, v in jax.jit(JaxBEVDet(jcfg).apply)(variables, image, *ranks).items()}


def _port_heads(cfg, state_dict, image, ranks):
    model = BEVDet(cfg)
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(image), *(torch.from_numpy(a) for a in ranks))
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("impl", ["interval", "scatter"])
def test_float32_heads_match_jax(impl, case):
    """Both frames' six head maps within 1e-4 of the JAX package's (the
    full-model bar), with either splat."""
    ranks, images, variables = case
    ranks = ranks if impl == "interval" else ranks[:3]
    for image in images:
        want = _jax_heads(jax_micro(), variables, image, ranks)
        got = _port_heads(bevdet_micro(), params_from_jax(variables), image, ranks)
        assert set(got) == set(HEADS)
        for k in HEADS:
            assert got[k].shape == want[k].shape and rel(got[k], want[k]) < 1e-4, (impl, k)


def test_bfloat16_heads_match_jax(case):
    """bfloat16 in both packages: each head within 5e-2 of the JAX bfloat16
    maps in the rms norm (measured: at most 1.3e-2, the heatmap; the two
    bfloat16 runs differ from float32 by about as much)."""
    ranks, images, variables = case
    want = _jax_heads(jax_micro(dtype="bfloat16"), variables, images[0], ranks)
    got = _port_heads(bevdet_micro(dtype="bfloat16"), params_from_jax(variables), images[0], ranks)
    for k in HEADS:
        assert np.isfinite(got[k]).all() and _rms(got[k], want[k]) < 5e-2, k


@pytest.mark.parametrize("quant", [True, "int8"])
def test_quantized_heads_match_jax(quant, case):
    """QDQ and int8 with the JAX package's `max` scales carried across.  As
    for BEVFormer's quantized tiers (test_torch_quant_model.py), rounding
    flips decorrelate the two packages' quantization noise, so each head is
    held in the rms norm: the port strays from the JAX package by no more
    than 1.5 times the JAX package's own quantization noise (its quantized
    maps against its float32 maps), and the port's noise is between half
    and twice the JAX package's."""
    ranks, images, variables = case
    jcfg = jax_micro(quant=quant)
    jax_policy.set_quant_exclude(())
    _, mut = jax.jit(lambda v, *a: JaxBEVDet(jax_micro(quant=True)).apply(
        v, *a, mutable=["amax_stats"]))(variables, images[0], *ranks)
    qvars = {**variables, "quant": amax_to_quant(mut["amax_stats"])}
    image = images[1]
    want = _jax_heads(jcfg, qvars, image, ranks)
    ref = _jax_heads(jax_micro(), variables, image, ranks)
    got = _port_heads(bevdet_micro(quant=quant), params_from_jax(qvars), image, ranks)
    for k in HEADS:
        noise = _rms(want[k], ref[k])
        assert np.isfinite(got[k]).all() and 0 < noise, k
        assert _rms(got[k], want[k]) < 1.5 * noise, (quant, k, _rms(got[k], want[k]), noise)
        assert 0.5 * noise < _rms(got[k], ref[k]) < 2.0 * noise, (quant, k)


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory, case):
    """A generated micro set and the case's seeded weights as an
    upstream-layout checkpoint."""
    tmp = tmp_path_factory.mktemp("bevdet_cli")
    root = make_synthetic_set(tmp / "set")
    variables = case[2]
    ckpt = str(tmp / "micro.pth")
    torch.save(bevdet_upstream_layout(bevdet_micro(), params_from_jax(variables)), ckpt)
    return tmp, root, ckpt, variables


def set_args(root):
    return ["--model", "micro", "--infos", str(root / SYNTH_INFOS), "--data-root", str(root),
            "--device", "cpu"]


def test_evaluate_cli_matches_the_jax_pipeline(cli_case):
    """tools/bevdet/evaluate.py (interval splat, ranks of the first frame's
    rig, native Scale-NMS) against the JAX tool's pipeline on the same
    loader frames: the same boxes kept, within 1e-4; the serial loop gives
    the pipelined loop's detections."""
    tmp, root, ckpt, variables = cli_case
    res = evaluate.main(set_args(root) + ["--checkpoint", ckpt])
    cfg = res.engine.cfg
    assert res.engine.valid_points > 50 and all(np.isfinite(v) for v in res.metrics.values())
    r = rig_ranks(cfg, res.frames.infos[0])
    ranks = (r.ranks_depth, r.ranks_feat, r.ranks_bev, r.interval_starts, r.interval_lengths)
    jcfg = jax_micro()
    apply = jax.jit(JaxBEVDet(jcfg).apply)
    kept = 0
    for i, det in zip(res.indices, res.run.detections):
        heads = apply(variables, res.frames.frame(i).image, *ranks)
        assert all(np.isfinite(np.asarray(h)).all() for h in heads.values())
        want = jax_post_process(jcfg, heads)
        assert len(det["boxes_3d"]) == len(want["boxes_3d"]), i
        for k in ("boxes_3d", "scores_3d", "labels_3d"):
            np.testing.assert_allclose(det[k], want[k], rtol=1e-4, atol=1e-4)
        kept += len(det["boxes_3d"])
    assert kept > 0
    serial = evaluate.eval_loop(res.engine, res.frames, res.indices, pipelined=False)
    for a, b in zip(serial.detections, res.run.detections):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert len(res.run.nms_ms) == len(res.indices)


@pytest.mark.parametrize("method", ["max", "entropy"])
def test_calibrate_cli_matches_the_jax_procedure(method, cli_case):
    """tools/bevdet/calibrate.py against the JAX tool's procedure
    (tools/bevdet/calibrate.py: the QDQ tier, the scatter splat on the first
    frame's rig, `quant.calibrate.calibrate` over the loader's images) on
    the same frames: the same sites, `max` scales within 1e-5, `entropy`
    within one histogram bin; the policy beside them; then an int8
    evaluation from those scales."""
    tmp, root, ckpt, variables = cli_case
    out = str(tmp / f"scales_{method}.npz")
    result = calibrate.main(set_args(root) + ["--checkpoint", ckpt, "--length", "2", "--method",
                                              method, "--exclude", "pts_bbox_head", "--out", out])
    assert CalibrationResult.load(out).scales == pytest.approx(result.scales)
    assert load_policy(out) == ("pts_bbox_head",)
    cfg = bevdet_micro()
    frames = evaluate.frames_of(cfg, str(root / SYNTH_INFOS), str(root))
    r = rig_ranks(cfg, frames.infos[0], intervals=False)
    ranks = tuple(jnp.asarray(a) for a in (r.ranks_depth, r.ranks_feat, r.ranks_bev))
    model = JaxBEVDet(jax_micro(quant=True))
    jax_policy.set_quant_exclude(())
    batches = [{"image": frames.frame(i).image} for i in range(2)]

    def apply_fn(v, batch, mutable):  # not jitted, as in the JAX tool
        return model.apply(v, jnp.asarray(batch["image"]), *ranks, mutable=mutable)[1]

    amax_stats, hist_stats = jax_collect_stats(apply_fn, variables, batches,
                                               with_hist=method != "max")
    want = jax_scales_from_stats(amax_stats, hist_stats, method=method)[1].scales
    assert sorted(result.scales) == sorted(want) and len(want) == 105
    amax = {"/".join(p[:-1]): float(v) for p, v in traverse_util.flatten_dict(amax_stats).items()}
    for name, scale in want.items():
        got = result.scales[name]
        if method == "max":
            assert got == pytest.approx(scale, rel=1e-5), name
        else:
            one_bin = amax[name] / NUM_BINS / 127.0
            assert abs(got - scale) <= one_bin * 1.001 + 1e-5 * scale, name
    if method == "max":
        res = evaluate.main(set_args(root) + ["--checkpoint", ckpt, "--quant-scales", out,
                                              "--quant", "int8"])
        assert res.engine.cfg.quant == "int8" and res.engine.cfg.quant_exclude == (
            "pts_bbox_head",)
        assert res.engine.model.img_backbone.stem_conv.wq.dtype == torch.int8
        assert res.engine.model.pts_bbox_head.heatmap.conv2.mode is False
        assert all(np.isfinite(v) for v in res.metrics.values())
