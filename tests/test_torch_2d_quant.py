"""The port's YOLOX and CenterNet detectors under the QDQ and int8 tiers
against the JAX package on the CPU (micro, and a micro CenterNet with the
DCNv2 neck), with the JAX package's `max` scales carried across.  A file of
its own: it compiles the JAX micro detectors' quantized tiers."""
import jax
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from bevformer_tensorrt_tpu.models.detectors.yolox import YOLOX as JaxYOLOX
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from test_torch_2d_model import _jax_out, _port_out, _rms
from test_torch_2d_model import case  # noqa: F401  (the module's fixture)
from torch_port_helpers import amax_to_quant

torch.set_num_threads(2)


@pytest.mark.parametrize("quant", [True, "int8"])
def test_quantized_matches_jax(quant, case):
    """QDQ and int8 with the JAX package's `max` scales carried across, at
    the bars of tests/test_torch_quant_model.py: rounding flips decorrelate
    the two packages' quantization noise, so each head map is held in the
    rms norm; the port strays from the JAX package by no more than 1.5
    times the JAX package's own quantization noise (its quantized maps
    against its float32 maps), and the port's noise is between half and
    twice the JAX package's."""
    name, cfg_fn, jcfg_fn, variables, port_sd, images = case
    jmodel = (JaxYOLOX if name.startswith("yolox") else JaxCenterNet)(jcfg_fn(quant=True))
    jax_policy.set_quant_exclude(())
    _, mut = jax.jit(lambda v, x: jmodel.apply(v, x, mutable=["amax_stats"]))(
        variables, images[:1])
    qvars = {**variables, "quant": amax_to_quant(mut["amax_stats"])}
    want = _jax_out(jcfg_fn(quant=quant), qvars, images)
    ref = _jax_out(jcfg_fn(), variables, images)
    sd = params_from_jax(qvars)
    if name != "centernet_micro":  # the upstream weights, and the scales from JAX
        sd = {**port_sd, **{k: v for k, v in sd.items() if k not in port_sd}}
    got = _port_out(cfg_fn(quant=quant), sd, images)
    for k in want:
        noise = _rms(want[k], ref[k])
        assert np.isfinite(got[k]).all() and 0 < noise, (name, k)
        assert _rms(got[k], want[k]) < 1.5 * noise, (name, quant, k, _rms(got[k], want[k]), noise)
        assert 0.5 * noise < _rms(got[k], ref[k]) < 2.0 * noise, (name, quant, k)
