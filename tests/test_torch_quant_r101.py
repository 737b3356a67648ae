"""Reduced base and small under the default int8 policy against the JAX
package (CPU, float32): R101 caffe style with DCNv2 on stages 3-4 at micro
widths, over two frames, the second temporal.

Off a TPU the JAX op keeps the floating-point DCN table under "int8" (its
`impl="auto"` is the XLA path there, which ignores `quant`), and it reaches
neither the int8 value tables nor int8 flash, so both packages exclude
`msda_tables` and `flash`.  The port then runs three ways on the same
weights and scales: with `dcn_tables` excluded as well (the JAX package's
function), under the policy as it stands (the int8 table on all 26 DCN
blocks: 256 and 512 channels, groups of 64), and in floating point.  The
scales are calibrated once, by the port (`max` over the two frames), and
carried into the flax model's "quant" collection; tests/test_torch_quant_model.py
holds the port's calibration to the JAX package's.

Bars, as in test_torch_quant_model.py::test_two_frames_match_jax: rounding
flips decorrelate two quantized runs until they differ by about what
quantization moves either, so each port run stays within 1.5 times that
noise of the JAX run, and its own noise against floating point within half
and twice the JAX run's.  The int8 table moves the port's outputs (it is in
use) by no more than 1.5 times the noise.  Measured, noise 1.8e-2 to 4.4e-2
rms: each port run 0.36 to 0.91 of the noise from the JAX run, its own noise
0.65 to 1.15 of the JAX run's, and the two tables 0.42 to 0.92 of the noise
apart.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import build_engine_case

torch.set_num_threads(2)

OFF_TPU = ("msda_tables", "flash")
DCN = (False, False, True, True)
R101 = dict(backbone_depth=101, dcn_stages=DCN, bev_h=20, bev_w=20, rotate_center=(10, 10))
CONFIGS = {
    "base_reduced": dict(R101, backbone_out_indices=(1, 2, 3), num_levels=4),
    "small_reduced": dict(R101, backbone_out_indices=(3,), num_levels=1),
}


def rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def quant_collection(scales):
    """The port's site -> scale result as a flax "quant" collection."""
    from flax import traverse_util

    return traverse_util.unflatten_dict(
        {tuple(site.split("/")) + ("scale",): np.float32(s) for site, s in scales.items()})


def outputs(engine, frames):
    out = []
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        out.append([np.asarray(t) for t in (engine.state.prev_bev, classes, coords)])
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_frames_under_the_default_int8_policy(name, monkeypatch):
    base = tuple(CONFIGS[name].items())
    cfg, _, _, variables, frames = build_engine_case("bevformer_micro", base)
    state = params_from_jax(variables)

    def port_engine(**over):
        case = build_engine_case("bevformer_micro", base + tuple(over.items()))
        return BEVFormerEngine(case[0], state_dict=state, device="cpu"), case

    qdq, _ = port_engine(quant=True, quant_exclude=OFF_TPU)
    scales = qdq.calibrate(frames, method="max").scales

    quantized = []
    real_quantize = dcn_ops.quantize_dcn_table
    monkeypatch.setattr(dcn_ops, "quantize_dcn_table",
                        lambda x, g, layout="NCHW": (quantized.append((x.shape[1], g)),
                                                     real_quantize(x, g, layout))[1])
    runs = {}
    for what, exclude in (("int8_table", OFF_TPU), ("float_table", OFF_TPU + ("dcn_tables",))):
        engine, _ = port_engine(quant="int8", quant_exclude=exclude)
        attach_quant_scales(engine.model, scales)
        quantized.clear()
        runs[what] = outputs(engine, frames)
        # 26 DCN blocks x 2 frames take the int8 table, in groups of 64 channels; none without it
        want = [(256, 64)] * 23 + [(512, 64)] * 3 if what == "int8_table" else []
        assert quantized == want * 2, what
    fp, _ = port_engine()
    runs["float"] = outputs(fp, frames)

    _, jcfg_q, model_q, _, _ = build_engine_case(
        "bevformer_micro", base + (("quant", "int8"), ("quant_exclude", OFF_TPU)))
    q_vars = {**variables, "quant": quant_collection(scales)}
    jax_policy.set_quant_exclude(OFF_TPU)  # the JAX package's policy is a global, read at trace
    try:
        jax_q = outputs(JaxEngine(model_q, q_vars, jcfg_q, donate_prev_bev=False), frames)
    finally:
        jax_policy.set_quant_exclude(())

    for i in range(len(frames)):
        for j, out in enumerate(("bev_embed", "classes", "coords")):
            want, ref = jax_q[i][j], runs["float"][i][j]
            noise = rms(ref, want)  # what quantization moves the JAX run (the port's float
            # run stands for the JAX package's: tests/test_torch_r101.py holds them to 1e-4)
            for what in ("int8_table", "float_table"):
                got = runs[what][i][j]
                assert got.shape == want.shape and np.isfinite(got).all(), (what, i, out)
                assert rms(got, want) < 1.5 * noise, (what, i, out, rms(got, want), noise)
                assert 0.5 * noise < rms(got, ref) < 2.0 * noise, (what, i, out)
            moved = rms(runs["int8_table"][i][j], runs["float_table"][i][j])
            assert 0 < moved < 1.5 * noise, (i, out, moved, noise)
