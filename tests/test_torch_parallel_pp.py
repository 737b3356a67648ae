"""The port's pipelines (`parallel/pipeline.py`, `pp_encoder.py`,
`pp_decoder.py`) on the CPU, in one world of eight gloo processes
(`torch_parallel_workers.py`): `pipeline_apply` and its gradients against
sequential application, and both pipelined BEVFormer stacks at dp2 x tp2 x
pp2 against the JAX package's sequential modules."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from torch_parallel_workers import run_world
from torch_port_helpers import random_variables

WORLD = 8


def _pp_encoder_case(rng):
    from bevformer_tensorrt_tpu.models.modules.encoder import BEVFormerEncoder
    from test_full_model_parity import micro_rig

    over = dict(cam_budget=1.0)
    cfg = jax_configs.bevformer_micro(msda_impl="jnp", **over)
    nq, C = cfg.bev_h * cfg.bev_w, cfg.embed_dims
    ss = ((8, 10),)
    a = dict(bev_query=rng.standard_normal((1, nq, C)).astype(np.float32),
             value=rng.standard_normal((cfg.num_cams, 80, C)).astype(np.float32),
             bev_pos=rng.standard_normal((1, nq, C)).astype(np.float32),
             lidar2img=np.asarray(micro_rig(cfg, rng), np.float32),
             prev_bev=rng.standard_normal((1, nq, C)).astype(np.float32),
             shift=np.asarray([0.01, -0.02], np.float32))
    enc = BEVFormerEncoder(cfg)
    order = (a["bev_query"], a["value"], a["bev_pos"], a["lidar2img"], a["prev_bev"], a["shift"])
    variables = random_variables(enc, rng, *order, np.float32(1.0), ss)
    want = np.asarray(enc.apply(variables, *order, jnp.float32(1.0), ss))
    return dict(over=over, variables=variables, args=a, spatial_shapes=ss, want=want)


def _pp_decoder_case(rng):
    from bevformer_tensorrt_tpu.models.heads.bevformer_head import RegBranch
    from bevformer_tensorrt_tpu.models.modules.decoder import DetectionTransformerDecoder

    cfg = jax_configs.bevformer_micro(msda_impl="jnp")
    C, nq, nk, F = cfg.embed_dims, cfg.num_query, cfg.bev_h * cfg.bev_w, 3
    dec = DetectionTransformerDecoder(cfg)
    regs = [RegBranch(cfg) for _ in range(cfg.decoder_layers)]
    a = dict(query=rng.standard_normal((1, nq, C)).astype(np.float32),
             query_pos=rng.standard_normal((1, nq, C)).astype(np.float32),
             values=rng.standard_normal((F, 1, nk, C)).astype(np.float32),
             ref=np.asarray(jax.nn.sigmoid(rng.standard_normal((1, nq, 3)).astype(np.float32))))
    reg_params = {f"reg_branch{i}": random_variables(regs[i], rng, a["query"])["params"]
                  for i in range(cfg.decoder_layers)}

    def reg_apply(lid, x):
        return regs[lid].apply({"params": reg_params[f"reg_branch{lid}"]}, x)

    shapes = jax.eval_shape(lambda: dec.init(jax.random.PRNGKey(0), a["query"], a["query_pos"],
                                             a["values"][0], a["ref"], reg_apply))
    variables = {"params": jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"])}
    outs = [dec.apply(variables, a["query"], a["query_pos"], a["values"][f], a["ref"], reg_apply)
            for f in range(F)]
    return dict(over={}, variables=variables, reg_params=reg_params, args=a,
                want_states=np.stack([np.asarray(o[0]) for o in outs]),
                want_refs=np.stack([np.asarray(o[1]) for o in outs]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_pp")
    rng = np.random.default_rng(1)
    for name, make in (("pp_encoder_case", _pp_encoder_case),
                       ("pp_decoder_case", _pp_decoder_case)):
        (work / f"{name}.pkl").write_bytes(pickle.dumps(make(rng)))
    return run_world(["pipeline", "pp_encoder", "pp_decoder"], WORLD, work)


@pytest.mark.parametrize("case,tol", [("forward", 2e-6), ("blocks_consts", 5e-6),
                                      ("grad", 5e-6), ("grad_x", 5e-6), ("grad_consts", 5e-6)])
def test_pipeline_matches_sequential(world, case, tol):
    """`pipeline_apply` against sequential application, and its gradients
    (each stage's parameters, the microbatches', the consts')."""
    for r, res in enumerate(world["pipeline"]):
        assert res[case] < tol, (r, case, res[case])


def test_pipeline_errors(world):
    """The JAX function's ValueErrors: a stage stack longer than the axis,
    consts whose leading axis is not the microbatch count."""
    errors = world["pipeline"][0]["errors"]
    assert len(errors) == 2
    assert "one stage per device required" in errors[0]
    assert "!= microbatch count" in errors[1]


def test_encoder_pp_matches_jax_sequential(world):
    """The encoder's layers as stages over query microbatches at dp2 x tp2 x
    pp2 against the JAX sequential encoder at use_prev_bev 1 (2e-5)."""
    for r, res in enumerate(world["pp_encoder"]):
        assert res["shape"] == (1, 64, 64)
        assert res["err"] < 2e-5, (r, res["err"])


@pytest.mark.parametrize("what", ["states", "refs"])
def test_decoder_pp_matches_jax_sequential(world, what):
    """The decoder's layers and reg branches as stages over 3 frames at dp2
    x tp2 x pp2 against the JAX sequential decoder, frame by frame (2e-5)."""
    for r, res in enumerate(world["pp_decoder"]):
        assert res["shape"] == (3, 2, 1, 16, 64)
        assert res[what] < 2e-5, (r, res[what])
