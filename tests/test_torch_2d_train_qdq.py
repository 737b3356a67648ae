"""2D training in the port against the JAX package on the CPU (YOLOX micro,
64 px, batch 2): the train CLI's optimizer against the JAX CLI's optax chain,
and a QDQ step against the JAX step with the same scales.  The weights and
the step's helpers are those of tests/test_torch_2d_train.py; a file of its
own, because each file compiles its JAX steps."""
import copy

import jax
import numpy as np
import optax
import torch

from bevformer_tensorrt_tpu.configs import yolox as jax_yolox_cfg
from bevformer_tensorrt_tpu.models.detectors.yolox import YOLOX as JaxYOLOX
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.runtime.torch_import import import_yolox_checkpoint
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
from bevformer_tensorrt_tpu_torch.models.detectors.yolox import YOLOX
from bevformer_tensorrt_tpu_torch.runtime.torch_import import load_yolox_checkpoint
from bevformer_tensorrt_tpu_torch.tools.det2d import train
from bevformer_tensorrt_tpu_torch.train import check_quant_scales
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from test_torch_2d_train import (
    TERMS,
    _batch,
    _jax_loss_and_grads,
    _port_loss_and_grads,
    _port_model,
    upstream_state_dict,
)
from torch_port_helpers import amax_to_quant, rel

torch.set_num_threads(2)


def _yolox():
    """(flax variables, port state_dict) of one seeded upstream state_dict."""
    sd = upstream_state_dict("yolox", yolox_micro())
    return import_yolox_checkpoint(sd), load_yolox_checkpoint(yolox_micro(), sd)


def test_optimizer_recipe_matches_the_optax_chain(rng):
    """The port's optimizer as the train CLI builds it against the JAX CLI's
    chain (clip_by_global_norm(35), adamw(1e-4, weight_decay=1e-4), a
    constant rate), fed the same gradients for 4 steps: the parameters
    within 1e-6 relative; the clip is exercised (the norm is above 35).
    Every parameter starts at a normal draw of 0.1: from zero (the seeded
    biases) a parameter is its updates alone, and optax's bias correction,
    1 - 0.999^t in float32, is 1.3e-5 off at t = 1 (the port's, in double,
    is within 2e-7 of a float64 AdamW), which would be the measure."""
    variables, _ = _yolox()
    params = jax.tree_util.tree_map(
        lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32), variables["params"])
    model = _port_model("yolox", yolox_micro(), params_from_jax({**variables, "params": params}))
    opt = train.make_optimizer(model, 1e-4)
    tx = optax.chain(optax.clip_by_global_norm(35.0), optax.adamw(1e-4, weight_decay=1e-4))
    state = tx.init(params)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, optax.global_norm(grads)

    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 5).astype(np.float32), params)
        params, state, norm = update(grads, state, params)
        assert float(norm) > 35
        g_port = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
        for n, p in model.named_parameters():
            p.grad = g_port[n].clone()
        opt.step()
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    for n, p in model.named_parameters():
        assert rel(p.detach().numpy(), want[n].numpy()) < 1e-6, n
    assert len(jax.tree_util.tree_leaves(params)) == len(list(model.parameters()))
    assert opt.lr(0) == opt.lr(10 ** 6) == 1e-4


def _nudged(model, seed, eps):
    """A copy of `model` whose stem BatchNorm weight moved by `eps`
    relative: a float32 change on the main path behind the first QDQ site
    (the image enters a QDQ site, whose rounding absorbs a 1e-7 change)."""
    nudged = copy.deepcopy(model)
    w = nudged.backbone.stem.conv.bn.weight
    noise = np.random.default_rng(seed).standard_normal(tuple(w.shape))
    with torch.no_grad():
        w.mul_(1 + eps * torch.from_numpy(noise).float())
    return nudged


def test_qdq_step_matches_jax():
    """YOLOX micro's QDQ step against the JAX step with the same `max`
    scales (one QDQ forward's amax), at the bars of
    test_torch_bevdet_train.py::test_qdq_step_matches_jax: a QDQ step is
    chaotic, so each loss term and the whole gradient stay within 3 times
    the largest move of three perturbations of the port's own step, at the
    smallest of 1e-7, 1e-6 and 1e-5 relative (of the stem BatchNorm's
    weight) that flips a rounding.  The QDQ loss differs from the float
    loss."""
    variables, port_sd = _yolox()
    batch = _batch(np.random.default_rng(17), 64)
    jax_policy.set_quant_exclude(())
    _, mut = jax.jit(lambda v, x: JaxYOLOX(jax_yolox_cfg.yolox_micro(quant=True)).apply(
        v, x, mutable=["amax_stats"]))(variables, batch["image"])
    quant = amax_to_quant(mut["amax_stats"])
    want_m, want_g = _jax_loss_and_grads("yolox", jax_yolox_cfg.yolox_micro(quant=True),
                                         variables, batch, quant)
    model = YOLOX(yolox_micro(quant=True))
    model.load_state_dict(params_from_jax({**variables, "quant": quant}), strict=True)
    check_quant_scales(model)
    got_m, got_g = _port_loss_and_grads(model.train(), batch)
    names = list(got_g)
    want_g = {n: w.numpy() for n, w in want_g.items()}
    assert set(want_g) == set(names)

    def l2(a, b):
        return np.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names)
                       / sum((b[n] ** 2).sum() for n in names))

    terms = TERMS["yolox"][1:]
    for eps in (1e-7, 1e-6, 1e-5):
        moves = []
        for seed in range(3):
            m, g = _port_loss_and_grads(_nudged(model, seed, eps), batch)
            moves.append(({k: abs(float(m[k]) - float(got_m[k])) for k in terms}, l2(g, got_g)))
        if max(sum(mv[0].values()) for mv in moves) > 0:  # a rounding flipped
            break
    for k in terms:
        bar = 3 * max(mv[0][k] for mv in moves)
        assert abs(float(got_m[k]) - float(want_m[k])) <= bar + 1e-5 * abs(float(want_m[k])), k
    assert all(np.isfinite(g).all() for g in got_g.values())
    assert l2(got_g, want_g) <= 3 * max(mv[1] for mv in moves)
    float_m, _ = _port_loss_and_grads(_port_model("yolox", yolox_micro(), port_sd), batch)
    assert abs(float(float_m["loss"]) - float(got_m["loss"])) > 1e-6
