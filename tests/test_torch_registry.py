"""The port's model registry and `tools/flops_params.py` against the JAX
package: every registered name builds (on the meta device: the full-width
tiers cost no memory or time), and its parameter count is exactly the JAX
package's count of the flax `params` collection (`jax.eval_shape`, nothing
compiled)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.registry import MODELS as JAX_MODELS
from bevformer_tensorrt_tpu.registry import build_model as jax_build_model
from bevformer_tensorrt_tpu_torch.registry import MODELS, build_model, count_params

torch.set_num_threads(2)
S = jax.ShapeDtypeStruct


def jax_params(name: str) -> int:
    """The JAX tool's count (`tools/flops_params.py::count_params`) of
    `name`'s params, from abstract inputs of the model's shapes."""
    model, cfg = jax_build_model(name)
    f32 = jnp.float32
    if name.startswith("bevformer"):
        nq = cfg.bev_h * cfg.bev_w
        args = (S((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), f32),
                S((nq, 1, cfg.embed_dims), f32), S((), f32), S((cfg.can_bus_dims,), f32),
                S((1, cfg.num_cams, 4, 4), f32))
    elif name.startswith("bevdet"):
        args = (S((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w), f32),
                *(S((8192,), jnp.int32),) * 3)
    else:
        args = (S((1, 3, cfg.img_size, cfg.img_size), f32),)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"]))


def test_registry_has_the_jax_names():
    assert list(MODELS) == list(JAX_MODELS)


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_parameter_count_equals_jax(name):
    model, cfg = build_model(name, device="meta")
    assert next(model.parameters()).device.type == "meta"
    assert type(cfg).__name__ == type(jax_build_model(name)[1]).__name__
    assert count_params(model) == jax_params(name), name


def test_build_model_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("yolox_micro")
    model, cfg = build_model("yolox_micro", device="cpu", dtype="bfloat16")
    assert cfg.dtype == "bfloat16" and next(model.parameters()).device.type == "cpu"
    a, _ = build_model("yolox_micro", device="cpu", seed=3)
    b, _ = build_model("yolox_micro", device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))


def test_flops_params_counts_a_frame_on_the_cpu(monkeypatch):
    """`tools/flops_params.py` at micro: the parameter count of the
    registry, every convolution's and dense layer's 2 x MACs by hooks, and
    the kernels' work by formula (BEVFormer: MSDA and flash)."""
    from bevformer_tensorrt_tpu_torch.tools import flops_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flops_params.main(["micro"])
    rec = flops_params.main(["micro", "yolox_micro", "--device", "cpu"])
    bev, yolox = rec["models"]
    assert bev["model"] == "bevformer_micro" and bev["params"] == jax_params("bevformer_micro")
    assert set(bev["flops_by_kind"]) == {"conv", "dense", "dcn", "msda", "flash"}
    assert all(bev["flops_by_kind"][k] > 0 for k in ("conv", "dense", "msda", "flash"))
    assert bev["flops"] == sum(bev["flops_by_kind"].values())
    # YOLOX-micro at its image size: convolutions only
    assert yolox["flops"] == yolox["flops_by_kind"]["conv"] > 0
