"""The port's parallel layer (`bevformer_tensorrt_tpu_torch/parallel/`) against
the JAX package on the CPU: mesh factoring and layout, the partition rules
against the JAX rules, the divisibility fallback, the int8 product's and the flash kernels' launch rules at the tp shares,
and, in one world of eight gloo processes (`torch_parallel_workers.py`),
the tp matmul chain and sequence-parallel micro inference at dp2 x tp4
against the JAX meshless forward.  The pipelines are in
test_torch_parallel_pp.py."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu import parallel as jax_parallel
from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.parallel import (
    DEFAULT_RULES,
    make_mesh,
    param_shardings,
    pick_dp_tp,
    spec_for_path,
)
from torch_parallel_workers import run_world
from torch_port_helpers import random_variables

WORLD = 8


class _FakeMesh:
    """The sizes of a mesh without processes (rules resolve on shapes alone)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def axis_size(self, axis):
        return self.shape.get(axis, 1)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_pick_dp_tp(n):
    assert pick_dp_tp(n) == jax_parallel.pick_dp_tp(n)


@pytest.mark.parametrize("dp,tp,pp", [(2, 4, None), (4, 2, None), (2, 2, 2), (1, 4, None)])
def test_mesh_layout(dp, tp, pp):
    """Rank r sits where `np.arange(n).reshape(dp, tp[, pp])` puts it, and
    each axis slice lists its ranks in order."""
    sizes = (dp, tp) + ((pp,) if pp else ())
    n = int(np.prod(sizes))
    grid = np.arange(n).reshape(sizes)
    for r in range(n):
        mesh = make_mesh(dp=dp, tp=tp, pp=pp, world_size=n, rank=r)
        idx = np.unravel_index(r, sizes)
        assert tuple(mesh.coords.values()) == tuple(int(i) for i in idx)
        for ax, name in enumerate(mesh.axis_names):
            line = list(idx)
            line[ax] = slice(None)
            assert mesh.ranks[name] == tuple(int(v) for v in grid[tuple(line)])
    assert make_mesh(world_size=8, rank=0).shape == {"dp": 2, "tp": 4}
    assert make_mesh(dp=4, world_size=8, rank=0).shape == {"dp": 4, "tp": 2}


def _flip(spec):
    return tuple(reversed(tuple(spec)))


def _jax_path(name, ndim):
    *mod, leaf = name.split(".")
    leaf = "kernel" if leaf == "weight" and ndim == 2 else leaf
    return "/".join((*mod, leaf))


@pytest.fixture(scope="module")
def micro_params():
    cfg = bevformer_micro()
    return {n: tuple(p.shape) for n, p in BEVFormer(cfg).named_parameters()}


@pytest.mark.parametrize("tp", [2, 4])
def test_specs_match_jax(micro_params, tp):
    """Every dense parameter of the port's micro model takes the JAX spec of
    its flax counterpart with the dims flipped, after the fallback."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:2 * tp]).reshape(2, tp), ("dp", "tp"))
    mesh = _FakeMesh(dp=2, tp=tp)

    class Shapes(torch.nn.Module):
        def named_parameters(self):
            return ((n, torch.empty(s, device="meta")) for n, s in micro_params.items())

    ours = param_shardings(mesh, Shapes())
    sharded = 0
    for name, shape in micro_params.items():
        if len(shape) != 2 and not name.endswith("bias"):
            assert ours[name] == ()
            continue
        path = _jax_path(name, len(shape))
        jshape = shape[::-1] if len(shape) == 2 else shape
        jspec = jax_parallel.param_shardings(jmesh, {"x": jnp.zeros(jshape)}, [
            (r"x", jax_parallel.spec_for_path(path))])["x"].spec
        want = _flip(jspec) if len(shape) == 2 else tuple(jspec)
        assert ours[name] == want, name
        sharded += any(ours[name])
    # an encoder layer: 3 (TSA) + 3 (SCA) + 3 (FFN); a decoder layer: 7 (MHA) + 3 + 3
    assert sharded == 2 * 9 + 2 * 13


def test_spec_resolution():
    """The JAX package's resolution cases, on the port's dotted names."""
    assert spec_for_path("pts_bbox_head.transformer.decoder.layer0.self_attn.q_proj.weight") == (
        "tp", None)
    assert spec_for_path("x.ffn.fc1.weight") == ("tp", None)
    assert spec_for_path("x.ffn.fc2.weight") == (None, "tp")
    assert spec_for_path("x.output_proj.weight") == (None, "tp")
    assert spec_for_path("img_backbone.layer1.0.conv1.weight") == ()
    assert spec_for_path("x.ffn.fc2.bias") == ()
    assert len(DEFAULT_RULES) == 7


def test_divisibility_fallback():
    """A rule whose sharded dim does not divide the axis falls back to
    replication, as `param_shardings` of the JAX package."""
    mesh = _FakeMesh(dp=2, tp=4)

    class M(torch.nn.Module):
        def __init__(self, out):
            super().__init__()
            self.ffn = torch.nn.Module()
            self.ffn.fc1 = torch.nn.Linear(8, out)

    assert param_shardings(mesh, M(6))["ffn.fc1.weight"] == ()
    assert param_shardings(mesh, M(8))["ffn.fc1.weight"] == ("tp", None)
    assert param_shardings(mesh, M(6))["ffn.fc1.bias"] == ()


@pytest.mark.parametrize("M,N,K", [(2500, 128, 256), (2500, 256, 256), (2500, 256, 128),
                                   (900, 128, 256), (900, 256, 128), (64, 16, 64), (64, 64, 32),
                                   (1250, 256, 256)])
def test_int8_tile_rule_at_tp_shapes(M, N, K):
    """The int8 product's tile rule and TMA boxes at the tp shares of the
    int8 dense layers (tiny at tp 2: value projections N/2, FFN fc1 N/2,
    the row-parallel K/2; micro at tp 4)."""
    cfg = int8_ops.gemm_config(M, N, K)
    _, bm, bn, _ = int8_ops.GEMM_CONFIGS[cfg]
    assert int8_ops.tensor_map_args(M, K, 0, bm)[0] == (K, M)
    assert int8_ops.tensor_map_args(N, K, 0, bn)[0] == (K, N)
    assert int8_ops.gemm_smem_bytes(cfg) <= int8_ops.SMEM_LIMIT


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_flash_geometry_at_four_heads(kind):
    """Tiny's decoder self-attention at tp 2: 4 heads of 32 channels, 900
    queries; every flash kernel takes the head width and launches."""
    geo = attn_ops.flash_launch_geometry(4, 900, 900, 32, kind)
    assert geo["grid"][1] == 4 and geo["smem"] <= attn_ops.SMEM_LIMIT
    assert 32 in attn_ops.INT8_FLASH_HEAD_DIMS


# --- the spawned world ------------------------------------------------------------


def _sp_case(rng):
    over = dict(encoder_layers=1, decoder_layers=1)
    jcfg = jax_configs.bevformer_micro(msda_impl="jnp", **over)
    model = JaxBEVFormer(jcfg)
    nq = jcfg.bev_h * jcfg.bev_w
    img = rng.standard_normal((1, jcfg.num_cams, 3, jcfg.img_h, jcfg.img_w)).astype(np.float32)
    prev = np.zeros((nq, 1, jcfg.embed_dims), np.float32)
    cb = np.zeros(jcfg.can_bus_dims, np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, jcfg.num_cams, 1, 1))
    l2i[..., 0, 0] = l2i[..., 1, 1] = jcfg.img_w / 2
    args = (img, prev, np.float32(0.0), cb, l2i)
    variables = random_variables(model, rng, *args)
    want = [np.asarray(w) for w in jax.jit(lambda v: model.apply(v, *args))(variables)]
    # a 16 x 16 grid: the 0.35 budget keeps 128 of 256 queries a camera
    big = dict(encoder_layers=2, decoder_layers=1, bev_h=16, bev_w=16, rotate_center=(8, 8))
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig

    bcfg = bevformer_micro(**big)
    bvars = random_variables(JaxBEVFormer(jax_configs.bevformer_micro(msda_impl="jnp", **big)),
                             rng, img, np.zeros((256, 1, bcfg.embed_dims), np.float32),
                             np.float32(0.0), cb, l2i)
    rig = camera_rig(bcfg.num_cams, bcfg.img_h, bcfg.img_w, rng)
    frames = [(img, np.zeros((256, 1, bcfg.embed_dims), np.float32), np.float32(0.0), cb, rig),
              (img, rng.standard_normal((256, 1, bcfg.embed_dims)).astype(np.float32),
               np.float32(1.0), cb, rig)]
    return dict(over=over, variables=variables, args=args, want=want,
                compaction=dict(over=big, variables=bvars, frames=frames))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    (work / "sp_case.pkl").write_bytes(pickle.dumps(_sp_case(rng)))
    return run_world(["tp_chain", "sp_micro"], WORLD, work)


def test_tp_matmul_chain(world):
    """Column-parallel fc1 -> row-parallel fc2 at dp2 x tp4 equals the
    unsharded product (1e-5); each rank holds a quarter of each weight."""
    for r, res in enumerate(world["tp_chain"]):
        assert res["err"] < 1e-5, (r, res["err"])
        assert res["shapes"] == ((32, 64), (64, 32))
        assert res["specs"]["ffn.fc1.weight"] == ("tp", None)
        assert res["specs"]["ffn.fc2.weight"] == (None, "tp")


def test_sequence_parallel_hooks(world):
    """Under a set mesh a [b, nq, C] tensor keeps this tp rank's nq / tp
    rows; a dim that does not divide, or an axis the mesh lacks, leaves it
    whole (the JAX function's rule); with no mesh every hook is the
    identity and the rows are the whole grid."""
    for r, res in enumerate(world["sp_micro"]):
        t = r % 4
        rows, ragged, other, sl, sl_ragged = res["hooks"]
        assert rows == tuple(float(v) for v in range(16 * t, 16 * t + 16))
        assert ragged == (1, 6, 3) and other == (1, 64, 3)
        assert sl == slice(16 * t, 16 * t + 16) and sl_ragged == slice(0, 66)
        assert res["hooks_no_mesh"] == ((1, 64, 3), slice(0, 64))


@pytest.mark.parametrize("name", ["bev_embed", "classes", "coords"])
def test_sp_inference_matches_jax_meshless(world, name):
    """Sequence-parallel micro inference at dp2 x tp4 against the JAX
    package's meshless forward (2e-5, as tests/test_parallel.py)."""
    for r, res in enumerate(world["sp_micro"]):
        assert res[name] < 2e-5, (r, res[name])


@pytest.mark.parametrize("frame", [0, 1])
def test_sp_inference_with_compaction(world, frame):
    """At a 16 x 16 grid the camera compaction runs (cam_budget 0.35) and
    crosses the query axis; on a first frame the history is the gathered
    layer input.  Sequence-parallel equals the port's meshless forward."""
    res = world["sp_micro"][0]  # every rank holds the gathered outputs; rank 0 compares
    for name in ("bev_embed", "classes", "coords"):
        assert res[f"compaction_frame{frame}_{name}"] < 2e-5, name
