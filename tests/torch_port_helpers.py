"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py): seeded
flax variables for a module and the relative-error measure."""
import jax
import numpy as np

from bevformer_tensorrt_tpu_torch.weights import params_from_jax


def rel(got, want) -> float:
    """max |got - want| / max |want| (the bar of test_full_model_parity.py)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def random_variables(module, rng, *args):
    """Flax variables of `module` for `args`, drawn from the numpy `rng`
    (shapes from `jax.eval_shape`, so no init is compiled): LeCun-scaled
    kernels, small biases, non-trivial norms and BatchNorm statistics,
    unit-normal embedding tables."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def init(*arrs):  # non-array arguments (shapes, None) stay static
        full = list(args)
        for i, a in zip(arrays, arrs):
            full[i] = a
        return module.init(jax.random.PRNGKey(0), *full)

    shapes = jax.eval_shape(init, *(args[i] for i in arrays))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        s = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(s[:-1]))
            return (rng.standard_normal(s) / np.sqrt(fan_in)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(s)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s).astype(np.float32)
        if name in ("row_embed", "col_embed"):
            return rng.random(s).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def load_port(port_module, variables):
    """Load flax `variables` into a port module through params_from_jax."""
    port_module.load_state_dict(params_from_jax(variables), strict=True)
    return port_module.eval()
