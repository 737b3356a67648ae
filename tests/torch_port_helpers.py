"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py): seeded
flax variables for a module, the relative-error measure, and the two-frame
comparison of the two packages' engines."""
import functools

import jax
import numpy as np
import torch

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

    # under `quant` an init also creates the (empty) calibration collections
    shapes = {k: v for k, v in dict(shapes).items() if k in ("params", "batch_stats")}
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def amax_to_quant(amax_stats):
    """A flax "amax_stats" collection -> the "quant" collection of `max`
    calibration (scale = max(amax, 1e-6) / 127, as tests/test_quant.py)."""
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, dict(amax_stats)))
    return traverse_util.unflatten_dict(
        {p[:-1] + ("scale",): np.float32(max(float(v), 1e-6) / 127.0) for p, v in flat.items()})


def model_batches(cfg, frames):
    """The detector's positional arguments for each frame, each starting a
    scene (zero prev_bev, use_prev_bev 0)."""
    nq = cfg.bev_h * cfg.bev_w
    return [(f["image"], np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
             f["can_bus"], f["lidar2img"]) for f in frames]


def load_port(port_module, variables):
    """Load flax `variables` into a port module through params_from_jax."""
    port_module.load_state_dict(params_from_jax(variables), strict=True)
    return port_module.eval()


def run_pair_nchw(jax_module, port_module, rng, *maps):
    """Apply an NHWC flax module and its NCHW port to the same numpy feature
    maps (given as NCHW) with one set of seeded weights.  Returns
    (jax_outs, port_outs): lists of numpy arrays, both NCHW."""
    nhwc = [np.ascontiguousarray(m.transpose(0, 2, 3, 1)) for m in maps]
    variables = random_variables(jax_module, rng, *nhwc)
    want = jax_module.apply(variables, *nhwc)
    load_port(port_module, variables)
    with torch.no_grad():
        got = port_module(*(torch.from_numpy(m) for m in maps))
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    return [np.asarray(w).transpose(0, 3, 1, 2) for w in want], [g.numpy() for g in got]


def engine_frames(cfg, rng):
    """Two frames of one scene; the ego car moves and turns in between, so
    the second frame rotates and shifts prev_bev."""
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig

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
def build_engine_case(fn, over=()):
    """(cfg, jcfg, flax model, seeded variables, frames) for the config
    function `fn` of both packages with the overrides `over` (a tuple of
    items, so the case is cached)."""
    from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
    from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
    from bevformer_tensorrt_tpu_torch.configs import bevformer as configs

    jcfg = getattr(jax_configs, fn)(msda_impl="jnp", **dict(over))
    cfg = getattr(configs, fn)(**dict(over))
    rng = np.random.default_rng(7)
    fr = engine_frames(cfg, rng)
    nq = cfg.bev_h * cfg.bev_w
    model = JaxBEVFormer(jcfg)
    variables = random_variables(
        model, rng, fr[0]["image"], np.zeros((nq, 1, cfg.embed_dims), np.float32),
        np.float32(0.0), fr[0]["can_bus"], fr[0]["lidar2img"])
    return cfg, jcfg, model, variables, fr


def check_two_frames(case, tol, what):
    """Both packages' BEVFormerEngine over the case's two frames: bev_embed,
    classes and coords of each frame agree within `tol`."""
    from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine

    cfg, jcfg, model, variables, fr = case
    jax_engine = JaxEngine(model, variables, jcfg, donate_prev_bev=False)
    engine = BEVFormerEngine(cfg, state_dict=params_from_jax(variables), device="cpu")
    for i, f in enumerate(fr):
        want = jax_engine.infer_frame(**f)
        got = engine.infer_frame(**f)
        assert engine.state.scene_token == "scene-0"
        pairs = [("bev_embed", engine.state.prev_bev, jax_engine.state.prev_bev),
                 ("classes", got[0], want[0]), ("coords", got[1], want[1])]
        for name, g, w in pairs:
            assert tuple(g.shape) == np.shape(w), (what, i, name)
            assert rel(g.numpy(), np.asarray(w)) < tol, (what, i, name)
