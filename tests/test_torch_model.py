"""The PyTorch port's whole slice against the JAX package (CPU, float32).

Micro, and tiny reduced as in test_bevformer_model.py (bev 20x20, 128x192
images, 100 queries; the camera compaction is active there, K 256 < 400),
run two frames through each package's BEVFormerEngine: the first starts a
scene, the second is temporal (rotated and shifted prev_bev).  The port runs
`BEVFormer(msda_impl="jnp")`'s seeded weights through `params_from_jax`;
bev_embed, classes and coords hold a relative error of 1e-4, the bar of
test_full_model_parity.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import build_engine_case, check_two_frames, rel

torch.set_num_threads(2)

TOL = 1e-4
CONFIGS = {
    "micro": ("bevformer_micro", dict()),
    "tiny_reduced": ("bevformer_tiny", dict(img_h=128, img_w=192, bev_h=20, bev_w=20,
                                            num_query=100)),
}


def build_case(name):
    fn, over = CONFIGS[name]
    return build_engine_case(fn, tuple(over.items()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_frames_match_jax(name):
    check_two_frames(build_case(name), TOL, name)


def test_use_prev_bev_mux():
    """Micro: with use_prev_bev = 0 the output ignores prev_bev; with 1 it
    does not, and matches JAX."""
    cfg, jcfg, model, variables, fr = build_case("micro")
    engine = BEVFormerEngine(cfg, state_dict=params_from_jax(variables), device="cpu")
    f = fr[1]
    nq = cfg.bev_h * cfg.bev_w
    prev = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (nq, 1, cfg.embed_dims)).astype(np.float32))
    args = (torch.from_numpy(f["image"]),)
    tail = (torch.from_numpy(f["can_bus"]), torch.from_numpy(f["lidar2img"]))
    with torch.no_grad():
        out0 = engine.model(*args, prev, torch.tensor(0.0), *tail)
        out0b = engine.model(*args, prev + 10.0, torch.tensor(0.0), *tail)
        out1 = engine.model(*args, prev, torch.tensor(1.0), *tail)
    np.testing.assert_allclose(out0[0].numpy(), out0b[0].numpy(), atol=1e-5)
    assert (out1[0] - out0[0]).abs().max() > 1e-4
    want1 = jax.jit(model.apply)(variables, f["image"], prev.numpy(), jnp.float32(1.0),
                                 f["can_bus"], f["lidar2img"])
    assert rel(out1[0].numpy(), np.asarray(want1[0])) < TOL
