"""The PyTorch port's ops against the JAX package's (CPU, float32).

MSDA: the port's plain version (through the public dispatcher, on CPU
tensors) against `multi_scale_deformable_attn`, its unchunked reference and
the Pallas sorted-tap kernel in interpret mode, over 1 and 4 levels, ppg 1
and 4, with offsets that push samples past every border.  Attention: the
port's plain version against `qkv` and the Pallas flash kernel in interpret
mode at a ragged length.  Every comparison holds a relative error of 1e-5.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.ops import (
    multi_scale_deformable_attn as jax_msda,
    multi_scale_deformable_attn_reference as jax_msda_reference,
    multi_scale_deformable_attn_sorted as jax_msda_sorted,
    qkv as jax_qkv,
)
from bevformer_tensorrt_tpu.ops import msda_sampling_locations as jax_locations
from bevformer_tensorrt_tpu.ops.pallas.flash_attn import flash_attention as jax_flash
from bevformer_tensorrt_tpu_torch.ops import (
    flash_attention,
    msda_sampling_locations,
    multi_head_attention,
    multi_scale_deformable_attn,
)
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
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0, 0]
