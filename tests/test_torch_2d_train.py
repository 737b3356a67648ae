"""2D training in the port against the JAX package on the CPU (micro, 64 px,
batch 2): one step of each family's criterion through its detector (YOLOX
micro; CenterNet micro with the DCNv2 neck) against the step of
`tools/2d/train.py`.  Both packages load one seeded upstream-layout
state_dict, the JAX package through its importer.  A file of its own: it
compiles the JAX micro train steps.  The criteria alone are in
tests/test_torch_losses2d.py, the optimizer and a QDQ step in
tests/test_torch_2d_train_qdq.py, the CLI in tests/test_torch_2d_train_cli.py."""
import jax
import jax.numpy as jnp
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
from bevformer_tensorrt_tpu.train import losses2d as jax_losses
from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
from bevformer_tensorrt_tpu_torch.models.detectors.centernet import CenterNet
from bevformer_tensorrt_tpu_torch.models.detectors.yolox import YOLOX
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    centernet_upstream_layout,
    load_centernet_checkpoint,
    load_yolox_checkpoint,
    yolox_upstream_layout,
)
from bevformer_tensorrt_tpu_torch.tools.det2d import train
from bevformer_tensorrt_tpu_torch.weights import init_weights, params_from_jax
from torch_port_helpers import rel

torch.set_num_threads(2)

B = 2
TERMS = {"yolox": ("loss", "loss_cls", "loss_obj", "loss_bbox"),
         "centernet": ("loss", "loss_heatmap", "loss_wh", "loss_offset")}


def _batch(rng, size):
    """Two images and their GT padded to the CLI's 64 rows: boxes of 8-40
    px, one pair of identical boxes, labels of the 80 classes."""
    image = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    gbs, gls = [], []
    for _ in range(B):
        n = 6
        xy = rng.uniform(0, size - 24, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 40, (n, 2)), size)], -1)
        boxes[1] = boxes[0]
        gb, gl = train.pad_gt(boxes.astype(np.float32), rng.integers(0, 80, n))
        gbs.append(gb)
        gls.append(gl)
    return {"image": image, "gt_boxes": np.stack(gbs), "gt_labels": np.stack(gls)}


def upstream_state_dict(fam, cfg, seed=0):
    """A seeded upstream-layout state_dict: the port's `init_weights`
    (LeCun-scaled, so that every parameter of a micro detector gets a
    gradient) written in the upstream layout."""
    model = (YOLOX if fam == "yolox" else CenterNet)(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    up = yolox_upstream_layout if fam == "yolox" else centernet_upstream_layout
    return {k: v.numpy() for k, v in up(cfg, model.state_dict()).items()}


def centernet_dcn(**o):
    return centernet_micro(use_dcn=True, **o)


def jax_centernet_dcn(**o):
    return jax_centernet_cfg.centernet_micro(use_dcn=True, **o)


@pytest.fixture(scope="module", params=["yolox", "centernet"])
def case(request):
    """(family, port cfg fn, JAX cfg fn, flax variables, port state_dict,
    batch): one seeded upstream-layout state_dict through both importers."""
    fam = request.param
    if fam == "yolox":
        cfg_fn, jcfg_fn = yolox_micro, jax_yolox_cfg.yolox_micro
        sd = upstream_state_dict(fam, cfg_fn())
        variables = import_yolox_checkpoint(sd)
        port_sd = load_yolox_checkpoint(cfg_fn(), sd)
    else:
        cfg_fn, jcfg_fn = centernet_dcn, jax_centernet_dcn
        cfg = cfg_fn()
        sd = upstream_state_dict(fam, cfg)
        variables = import_centernet_checkpoint(sd, depth=cfg.backbone_depth)
        port_sd = load_centernet_checkpoint(cfg, sd)
    batch = _batch(np.random.default_rng(17), cfg_fn().img_size)
    return fam, cfg_fn, jcfg_fn, variables, port_sd, batch


def _jax_loss_and_grads(fam, jcfg, variables, batch, quant=None):
    """The loss terms (means over the batch) and gradients of
    tools/2d/train.py's `loss_fn` under `jax.value_and_grad`."""
    model = (JaxYOLOX if fam == "yolox" else JaxCenterNet)(jcfg)
    extra = {k: v for k, v in variables.items() if k != "params"}
    if quant is not None:
        extra["quant"] = quant
    jax_policy.set_quant_exclude(())

    def loss_fn(params):
        outs = model.apply({"params": params, **extra}, jnp.asarray(batch["image"]))
        terms = []
        for i in range(B):
            gb, gl = jnp.asarray(batch["gt_boxes"][i]), jnp.asarray(batch["gt_labels"][i])
            if fam == "yolox":
                terms.append(jax_losses.yolox_loss_single(outs, gb, gl, jcfg.num_classes,
                                                          img_idx=i))
            else:
                terms.append(jax_losses.centernet_loss_single(outs, gb, gl, jcfg.num_classes,
                                                              stride=4, img_idx=i))
        mean = {k: sum(t[k] for t in terms) / B for k in TERMS[fam]}
        return mean["loss"], {**mean, "num_pos": sum(t["num_pos"] for t in terms)}

    (_, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return m, params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})


def _port_model(fam, cfg, state_dict):
    model = (YOLOX if fam == "yolox" else CenterNet)(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.train()


def _port_loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    metrics = train.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    metrics["loss"].backward()
    return ({k: v.detach() for k, v in metrics.items() if k != "assigned"},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for n, p in model.named_parameters()})


def _noisy(batch, seed):
    noise = np.random.default_rng(seed).standard_normal(batch["image"].shape)
    return {**batch, "image": (batch["image"] * (1 + 1e-7 * noise)).astype(np.float32)}


def test_train_step_loss_and_gradients_match_jax(case):
    """The micro step against the JAX CLI's: the loss terms within 1e-5 and
    each parameter's gradient within 1e-4 of its largest magnitude, or within
    twice what a 1e-7 relative change of the images moves the port's own
    gradient where that is more (the bars of test_torch_bevdet_train.py);
    over all parameters the relative L2 error under 1e-5."""
    fam, cfg_fn, jcfg_fn, variables, port_sd, batch = case
    want_m, want_g = _jax_loss_and_grads(fam, jcfg_fn(), variables, batch)
    model = _port_model(fam, cfg_fn(), port_sd)
    got_m, got_g = _port_loss_and_grads(model, batch)
    _, moved = _port_loss_and_grads(model, _noisy(batch, 3))
    for k in TERMS[fam]:
        assert rel(float(got_m[k]), float(want_m[k])) < 1e-5, k
    assert float(got_m["num_pos"]) == float(want_m["num_pos"]) > 0
    assert set(got_g) == set(want_g)
    at_1e4, compared, num, den = 0, 0, 0.0, 0.0
    for name, w in want_g.items():
        w = w.numpy()
        scale = np.abs(w).max()
        if scale == 0:  # a branch with no foreground prior this step, in both packages
            assert np.abs(got_g[name]).max() == 0, name
            continue
        compared += 1
        err = np.abs(got_g[name] - w).max() / scale
        chaos = np.abs(moved[name] - got_g[name]).max() / scale
        assert err <= max(1e-4, 2 * chaos), (name, err, chaos)
        at_1e4 += err <= 1e-4
        num += ((got_g[name] - w) ** 2).sum()
        den += (w ** 2).sum()
    assert compared >= 0.9 * len(want_g) and at_1e4 >= 0.9 * compared
    assert np.sqrt(num / den) < 1e-5
