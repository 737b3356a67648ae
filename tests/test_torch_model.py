"""The PyTorch port's whole slice against the JAX package (CPU, float32).

Micro, and tiny reduced as in test_bevformer_model.py (bev 20x20, 128x192
images, 100 queries; the camera compaction is active there, K 256 < 400),
run two frames through each package's BEVFormerEngine: the first starts a
scene, the second is temporal (rotated and shifted prev_bev).  The port runs
`BEVFormer(msda_impl="jnp")`'s seeded weights through `params_from_jax`;
bev_embed, classes and coords hold a relative error of 1e-4, the bar of
test_full_model_parity.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine
from bevformer_tensorrt_tpu_torch.configs import bevformer as configs
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import random_variables, rel

torch.set_num_threads(2)

TOL = 1e-4
CONFIGS = {
    "micro": ("bevformer_micro", dict()),
    "tiny_reduced": ("bevformer_tiny", dict(img_h=128, img_w=192, bev_h=20, bev_w=20,
                                            num_query=100)),
}


def frames(cfg, rng):
    l2i = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    can_bus = rng.standard_normal(cfg.can_bus_dims).astype(np.float32)
    out = []
    for _ in range(2):
        out.append(dict(
            image=rng.standard_normal((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32),
            can_bus=can_bus.copy(), lidar2img=l2i, scene_token="scene-0"))
        can_bus = can_bus.copy()
        can_bus[:3] += rng.normal(0, 1.0, 3).astype(np.float32)   # ego moves ...
        can_bus[-2:] += np.float32(0.1)                          # ... and turns
    return out


@functools.lru_cache(maxsize=None)
def build_case(name):
    fn, over = CONFIGS[name]
    jcfg = getattr(jax_configs, fn)(msda_impl="jnp", **over)
    cfg = getattr(configs, fn)(**over)
    rng = np.random.default_rng(7)
    fr = frames(cfg, rng)
    nq = cfg.bev_h * cfg.bev_w
    model = JaxBEVFormer(jcfg)
    variables = random_variables(
        model, rng, fr[0]["image"], np.zeros((nq, 1, cfg.embed_dims), np.float32),
        np.float32(0.0), fr[0]["can_bus"], fr[0]["lidar2img"])
    return cfg, jcfg, model, variables, fr


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_frames_match_jax(name):
    cfg, jcfg, model, variables, fr = build_case(name)
    jax_engine = JaxEngine(model, variables, jcfg, donate_prev_bev=False)
    engine = BEVFormerEngine(cfg, state_dict=params_from_jax(variables), device="cpu")
    for i, f in enumerate(fr):
        want = jax_engine.infer_frame(**f)
        got = engine.infer_frame(**f)
        assert engine.state.scene_token == "scene-0"
        pairs = [("bev_embed", engine.state.prev_bev, jax_engine.state.prev_bev),
                 ("classes", got[0], want[0]), ("coords", got[1], want[1])]
        for what, g, w in pairs:
            assert tuple(g.shape) == np.shape(w), (name, i, what)
            assert rel(g.numpy(), np.asarray(w)) < TOL, (name, i, what)


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
