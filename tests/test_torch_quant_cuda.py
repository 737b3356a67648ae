"""The quantization scales computed on the card: bit for bit the CPU's (and
so the JAX package's).  CUDA divides a tensor by a Python number as a
product with the number's reciprocal, which can sit one ulp off the quotient;
the scales divide by a 0-dim tensor on the data's device instead.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_quant_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.quant.fake_quant import per_channel_scale
from bevformer_tensorrt_tpu_torch.quant.fold import quantize_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(4096, 64, 3, 3, generator=g) / 24.0


def test_the_reciprocal_product_is_what_the_scales_avoid(cuda):
    """The parent's expression, `amax / 127.0` on the card, is one ulp off
    the CPU's for some of these 4096 channels: the tests below would fail
    without the 0-dim divisor."""
    amax = _weights().abs().amax(dim=(1, 2, 3))
    assert not torch.equal((amax.to(cuda) / 127.0).cpu(), amax / 127.0)


def test_weight_fold_and_fake_quant_scale_match_the_cpu(cuda):
    w = _weights()
    wq, wscale = quantize_weight(w.to(cuda))
    want_q, want_s = quantize_weight(w)
    assert torch.equal(wscale.cpu(), want_s) and torch.equal(wq.cpu(), want_q)
    assert torch.equal(per_channel_scale(w.to(cuda)).cpu(), per_channel_scale(w))


def test_table_scales_match_the_cpu(cuda):
    rng = np.random.default_rng(0)
    value = torch.from_numpy((rng.standard_normal((6, 2000, 8, 32)) * 3).astype(np.float32))
    q, s = msda_ops.quantize_value_table(value.to(cuda))
    want_q, want_s = msda_ops.quantize_value_table(value)
    assert torch.equal(s.cpu(), want_s) and torch.equal(q.cpu(), want_q)
    x = torch.from_numpy((rng.standard_normal((6, 1024, 15, 25)) * 5).astype(np.float32))
    assert torch.equal(dcn_ops.dcn_table_scale(x.to(cuda), 64).cpu(),
                       dcn_ops.dcn_table_scale(x, 64))
