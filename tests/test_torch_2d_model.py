"""The port's YOLOX and CenterNet detectors against the JAX package on the
CPU (micro, and a micro CenterNet with the DCNv2 neck): from the same
upstream-layout state_dicts (tests/test_import_2d.py's builders) through
each package's importer at 1e-4 in float32, bfloat16 in the rms norm; the
upstream-layout round trip.  A file of its own: it compiles the JAX micro
detectors.  The QDQ and int8 tiers are in tests/test_torch_2d_quant.py, the
CLIs in tests/test_torch_2d_cli.py."""
import jax
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs import centernet as jax_centernet_cfg
from bevformer_tensorrt_tpu.configs import yolox as jax_yolox_cfg
from bevformer_tensorrt_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from bevformer_tensorrt_tpu.models.detectors.yolox import YOLOX as JaxYOLOX
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.runtime.torch_import import (
    import_centernet_checkpoint,
    import_yolox_checkpoint,
)
from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro, centernet_r18
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro, yolox_s, yolox_x
from bevformer_tensorrt_tpu_torch.models.detectors.centernet import CenterNet
from bevformer_tensorrt_tpu_torch.models.detectors.yolox import YOLOX
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    centernet_upstream_layout,
    load_centernet_checkpoint,
    load_yolox_checkpoint,
    yolox_upstream_layout,
)
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from test_import_2d import synthetic_centernet_state_dict, synthetic_yolox_state_dict
from torch_port_helpers import random_variables, rel

torch.set_num_threads(2)

# name -> (port config, JAX config)
CASES = {
    "yolox_micro": (yolox_micro, jax_yolox_cfg.yolox_micro),
    "centernet_micro": (centernet_micro, jax_centernet_cfg.centernet_micro),
    "centernet_micro_dcn": (lambda **o: centernet_micro(use_dcn=True, **o),
                            lambda **o: jax_centernet_cfg.centernet_micro(use_dcn=True, **o)),
}


def _flat(out):
    """{name: NCHW numpy} of a detector's outputs, JAX (NHWC) or port."""
    items = (out.items() if isinstance(out, dict)
             else ((f"l{i}_{k}", v) for i, o in enumerate(out) for k, v in o.items()))
    return {k: (v.float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32).transpose(0, 3, 1, 2)) for k, v in items}


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, port cfg fn, JAX cfg fn, flax variables, port state_dict,
    images): yolox_micro and the DCN CenterNet from the upstream builders
    through both importers, the plain micro CenterNet from seeded flax
    variables."""
    name = request.param
    cfg_fn, jcfg_fn = CASES[name]
    cfg = cfg_fn()
    rng = np.random.default_rng(11)
    images = rng.standard_normal((2, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    if name == "yolox_micro":
        sd = synthetic_yolox_state_dict(cfg, np.random.default_rng(3))
        variables = import_yolox_checkpoint(sd)
        port_sd = load_yolox_checkpoint(cfg, sd)
    elif name == "centernet_micro_dcn":
        sd = synthetic_centernet_state_dict(cfg, np.random.default_rng(5), cfg.deconv_filters)
        variables = import_centernet_checkpoint(sd, depth=cfg.backbone_depth)
        port_sd = load_centernet_checkpoint(cfg, sd)
    else:
        variables = random_variables(JaxCenterNet(jcfg_fn()), rng, images)
        port_sd = params_from_jax(variables)
    return name, cfg_fn, jcfg_fn, variables, port_sd, images


def _port_model(cfg, state_dict):
    model = (YOLOX if cfg.name.startswith("yolox") else CenterNet)(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _jax_out(jcfg, variables, images):
    model = (JaxYOLOX if jcfg.name.startswith("yolox") else JaxCenterNet)(jcfg)
    jax_policy.set_quant_exclude(())
    return _flat(jax.jit(model.apply)(variables, images))


def _port_out(cfg, state_dict, images):
    with torch.no_grad():
        return _flat(_port_model(cfg, state_dict)(torch.from_numpy(images)))


def test_float32_matches_jax(case):
    """Every head map of a batch of two within 1e-4 of the JAX package's
    (the full-model bar), the port loading the upstream state_dict directly
    and the JAX package through its importer."""
    name, cfg_fn, jcfg_fn, variables, port_sd, images = case
    want = _jax_out(jcfg_fn(), variables, images)
    got = _port_out(cfg_fn(), port_sd, images)
    assert set(got) == set(want) and len(got) in (3, 9)
    for k in want:
        assert got[k].shape == want[k].shape and rel(got[k], want[k]) < 1e-4, (name, k)


def test_bfloat16_matches_jax(case):
    """bfloat16 in both packages: each head map within 5e-2 of the JAX
    bfloat16 maps in the rms norm, and of the same dtype (CenterNet's
    transposed convs compute float32 in both, so its heads are float32)."""
    name, cfg_fn, jcfg_fn, variables, port_sd, images = case
    want = _jax_out(jcfg_fn(dtype="bfloat16"), variables, images)
    model = _port_model(cfg_fn(dtype="bfloat16"), port_sd)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    dtypes = {v.dtype for v in (out.values() if isinstance(out, dict)
                                else (t for o in out for t in o.values()))}
    assert dtypes == {torch.bfloat16 if name.startswith("yolox") else torch.float32}
    got = _flat(out)
    for k in want:
        assert np.isfinite(got[k]).all() and _rms(got[k], want[k]) < 5e-2, (name, k)


@pytest.mark.parametrize("make,upstream,load", [
    (yolox_x, yolox_upstream_layout, load_yolox_checkpoint),
    (yolox_s, yolox_upstream_layout, load_yolox_checkpoint),
    (centernet_r18, centernet_upstream_layout, load_centernet_checkpoint),
])
def test_full_tiers_build_and_round_trip(make, upstream, load):
    """YOLOX-x and -s and CenterNet-R18 (DCNv2 neck) build, and their
    state_dicts go through the upstream layout and back unchanged; the
    upstream keys and shapes are those of tests/test_import_2d.py's builders
    (whose dicts the JAX importer reads; YOLOX-x's 99M weights are not drawn
    twice), and an unknown key raises."""
    cfg = make()
    model = (YOLOX if cfg.name.startswith("yolox") else CenterNet)(cfg)
    sd = {k: v for k, v in model.state_dict().items()}
    up = upstream(cfg, sd)
    back = load(cfg, up)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    if cfg.name == "yolox-s":
        want = synthetic_yolox_state_dict(cfg, np.random.default_rng(0))
        assert {k: tuple(v.shape) for k, v in up.items()} == {
            k: v.shape for k, v in want.items()}
    elif cfg.name.startswith("centernet"):
        want = synthetic_centernet_state_dict(cfg, np.random.default_rng(0), cfg.deconv_filters)
        assert {k: tuple(v.shape) for k, v in up.items()} == {
            k: v.shape for k, v in want.items()}
    with pytest.raises(KeyError, match="takes no key"):
        load(cfg, {**up, "bbox_head.extra.weight": torch.zeros(1)})
