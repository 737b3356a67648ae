"""BEVDet training in the port against the JAX package on the CPU (micro):
the CenterPoint targets and loss, both splats' gradients, the train step's
loss and gradients against the step of `tools/bevdet/train.py`, the
optimizer recipe against its optax chain, and a QDQ step.  The train CLI and the
accuracy cycle are in tests/test_torch_bevdet_train_cli.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevformer_tensorrt_tpu.configs.bevdet import bevdet_micro as jax_micro
from bevformer_tensorrt_tpu.models.detectors.bevdet import BEVDet as JaxBEVDet
from bevformer_tensorrt_tpu.ops.bev_pool import bev_pool_v2 as jax_bev_pool
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.train import losses_bevdet as jax_losses
from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevdet import BEVDet
from bevformer_tensorrt_tpu_torch.models.necks.view_transformer import (
    get_lidar_coor,
    voxel_pooling_prepare,
)
from bevformer_tensorrt_tpu_torch.ops.bev_pool import bev_pool_v2
from bevformer_tensorrt_tpu_torch.runtime.synthetic import bevdet_rig
from bevformer_tensorrt_tpu_torch.tools.bevdet import train
from bevformer_tensorrt_tpu_torch.train import check_quant_scales, losses_bevdet
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import amax_to_quant, random_variables, rel

torch.set_num_threads(2)

HEADS = ("reg", "height", "dim", "rot", "vel", "heatmap")
HEAD_CH = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2, "heatmap": 10}


def _gt(rng, G=12):
    """GT over micro's 16 x 16 m grid: valid boxes with negative and positive
    coordinates, two whose centres lie off the grid (one just below its
    lower edge, where truncating instead of flooring would keep it), and
    padding rows holding junk."""
    boxes = np.zeros((G, 9), np.float32)
    boxes[:, :2] = rng.uniform(-7.5, 7.5, (G, 2))
    boxes[:, 2] = rng.uniform(-2, 1, G)
    boxes[:, 3:6] = rng.uniform(0.4, 4, (G, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, G)
    boxes[:, 7:] = rng.normal(size=(G, 2))
    boxes[0, :2] = (-8.4, 3.0)    # floor -> -1: off the grid
    boxes[1, :2] = (2.0, 8.6)     # cy 16.6: off the grid
    boxes[2, :2] = (-7.9, -7.95)  # the first cell
    labels = rng.integers(0, 10, G).astype(np.int32)
    labels[-3:] = -1
    boxes[-3:] = rng.normal(0, 50, (3, 9))
    return boxes, labels


def test_targets_and_loss_match_jax(rng):
    """`bevdet_targets` and `bevdet_loss_single` on random head maps within
    1e-6 of the JAX package's, and the masking of off-grid and padding rows."""
    cfg, jcfg = bevdet_micro(), jax_micro()
    boxes, labels = _gt(rng)
    want = jax_losses.bevdet_targets(jcfg, jnp.asarray(boxes), jnp.asarray(labels))
    got = losses_bevdet.bevdet_targets(cfg, torch.from_numpy(boxes),
                                       torch.from_numpy(labels.astype(np.int64)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy().astype(np.float64), np.asarray(w), rtol=0, atol=1e-6)
    mask = got[3].numpy()
    assert not mask[:2].any() and mask[2] and not mask[-3:].any() and mask.sum() == 7
    assert float(got[0].max()) == 1.0
    jheads = {k: rng.standard_normal((1, 16, 16, HEAD_CH[k])).astype(np.float32) for k in HEADS}
    want = jax_losses.bevdet_loss_single(jcfg, jheads, jnp.asarray(boxes), jnp.asarray(labels))
    heads = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in jheads.items()}
    got = losses_bevdet.bevdet_loss_single(cfg, heads, torch.from_numpy(boxes),
                                           torch.from_numpy(labels.astype(np.int64)))
    for k in ("loss_heatmap", "loss_bbox", "loss", "num_pos"):
        assert rel(float(got[k]), float(want[k])) < 1e-6, k
    assert losses_bevdet.CODE_WEIGHTS == jax_losses.CODE_WEIGHTS
    assert (losses_bevdet.LOSS_BBOX_WEIGHT, losses_bevdet.GAUSSIAN_OVERLAP,
            losses_bevdet.MIN_RADIUS) == (jax_losses.LOSS_BBOX_WEIGHT,
                                          jax_losses.GAUSSIAN_OVERLAP, jax_losses.MIN_RADIUS)


@pytest.fixture(scope="module")
def case():
    """(ranks with intervals, image, GT, seeded flax variables) on a surround
    rig at micro."""
    cfg = bevdet_micro()
    rng = np.random.default_rng(5)
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, rng)
    r = voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=600,
                              pad_intervals_to=cfg.bev_h * cfg.bev_w)
    ranks = (r.ranks_depth, r.ranks_feat, r.ranks_bev, r.interval_starts, r.interval_lengths)
    image = rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w)).astype(np.float32)
    boxes, labels = _gt(rng)
    variables = random_variables(JaxBEVDet(jax_micro()), rng, image, *ranks)
    return ranks, image, boxes, labels, variables


@pytest.mark.parametrize("impl", ["interval", "scatter"])
def test_splat_gradients_match_jax(impl, case, rng):
    """Both splats' VJP (stock ops under autograd) against `jax.vjp` of the
    JAX package's `bev_pool_v2` within 1e-5 of each gradient's largest
    magnitude; the padding ranks (-1) read index 0 but add no gradient."""
    ranks = case[0] if impl == "interval" else case[0][:3]
    cfg = bevdet_micro()
    depth = rng.random((cfg.num_cams, cfg.depth_bins, cfg.feat_h, cfg.feat_w)).astype(np.float32)
    feat = rng.standard_normal((cfg.num_cams, cfg.feat_h, cfg.feat_w, 8)).astype(np.float32)
    kw = dict(out_height=cfg.bev_h, out_width=cfg.bev_w, impl=impl)
    out, vjp = jax.vjp(lambda d, f: jax_bev_pool(d, f, *ranks, **kw), depth, feat)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    d, f = (torch.from_numpy(a).requires_grad_() for a in (depth, feat))
    got = bev_pool_v2(d, f, *(torch.from_numpy(np.asarray(a)) for a in ranks), **kw)
    assert rel(got.detach().numpy(), np.asarray(out)) < 1e-5
    got.backward(torch.from_numpy(cot))
    for g, w in zip((d.grad, f.grad), want):
        assert np.abs(np.asarray(w)).max() > 0 and rel(g.numpy(), np.asarray(w)) < 1e-5
    # every point padded away: no gradient reaches depth or features
    pads = tuple(np.full_like(np.asarray(a), -1) if i == 2 else np.asarray(a)
                 for i, a in enumerate(ranks))
    if impl == "interval":
        pads = pads[:3] + (pads[3], np.zeros_like(pads[4]))
    d.grad = f.grad = None
    bev_pool_v2(d, f, *(torch.from_numpy(a) for a in pads), **kw).backward(torch.from_numpy(cot))
    assert not d.grad.abs().max() and not f.grad.abs().max()


def _jax_loss_and_grads(jcfg, variables, image, ranks, boxes, labels, quant=None):
    """The loss and gradients of tools/bevdet/train.py's `loss_fn` under
    `jax.value_and_grad` (its step, before the optimizer)."""
    model = JaxBEVDet(jcfg)
    extra = {"batch_stats": variables["batch_stats"], **({"quant": quant} if quant else {})}

    def loss_fn(params):
        heads = model.apply({"params": params, **extra}, jnp.asarray(image), *ranks)
        li = jax_losses.bevdet_loss_single(jcfg, heads, jnp.asarray(boxes), jnp.asarray(labels))
        return li["loss"], li

    (_, li), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return li, params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})


def _port_loss_and_grads(model, image, ranks, boxes, labels):
    model.zero_grad(set_to_none=True)
    batch = {"image": torch.from_numpy(image), "gt_boxes": torch.from_numpy(boxes),
             "gt_labels": torch.from_numpy(labels.astype(np.int64))}
    metrics = train.loss_fn(model, tuple(torch.from_numpy(np.asarray(a)) for a in ranks), batch)
    metrics["loss"].backward()
    return ({k: v.detach() for k, v in metrics.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for n, p in model.named_parameters()})


def _port_model(cfg, variables):
    model = BEVDet(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.train()


def _noisy(image, seed):
    noise = np.random.default_rng(seed).standard_normal(image.shape)
    return (image * (1 + 1e-7 * noise)).astype(np.float32)


def test_train_step_loss_and_gradients_match_jax(case):
    """The micro step against the JAX CLI's: the loss terms within 1e-5 and
    each parameter's gradient within 1e-4 of its largest magnitude, or within
    twice what a 1e-7 relative change of the image moves the port's own
    gradient where that is more (the bars of test_torch_train_step.py); over
    all parameters the relative L2 error under 1e-5."""
    ranks, image, boxes, labels, variables = case
    want_m, want_g = _jax_loss_and_grads(jax_micro(), variables, image, ranks, boxes, labels)
    model = _port_model(bevdet_micro(), variables)
    got_m, got_g = _port_loss_and_grads(model, image, ranks, boxes, labels)
    _, moved = _port_loss_and_grads(model, _noisy(image, 3), ranks, boxes, labels)
    for k in ("loss", "loss_heatmap", "loss_bbox"):
        assert rel(float(got_m[k]), float(want_m[k])) < 1e-5, k
    assert float(got_m["num_pos"]) == float(want_m["num_pos"]) == 7
    assert set(got_g) == set(want_g)
    at_1e4, num, den = 0, 0.0, 0.0
    for name, w in want_g.items():
        w = w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(got_g[name] - w).max() / scale
        chaos = np.abs(moved[name] - got_g[name]).max() / scale
        assert err <= max(1e-4, 2 * chaos), (name, err, chaos)
        at_1e4 += err <= 1e-4
        num += ((got_g[name] - w) ** 2).sum()
        den += (w ** 2).sum()
    assert at_1e4 >= 0.9 * len(want_g)
    assert np.sqrt(num / den) < 1e-5


def test_optimizer_recipe_matches_the_optax_chain(case, rng):
    """The port's optimizer as the train CLI builds it against the JAX CLI's
    chain (clip 35, AdamW with weight decay 1e-2 on
    warmup_cosine_decay_schedule(0, lr, warmup, steps) ending at 0), fed the
    same gradients for 4 steps of a 5-step schedule: the parameters within
    1e-6 relative; the clip is exercised (the gradients' norm is above 35)."""
    variables = case[4]
    steps, lr = 5, 2e-4
    model = _port_model(bevdet_micro(), variables)
    opt = train.make_optimizer(model, lr, steps)
    warmup = min(500, max(1, steps // 5))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(35.0), optax.adamw(sched, weight_decay=1e-2))
    params = variables["params"]
    state = tx.init(params)
    leaves = jax.tree_util.tree_leaves(params)

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
    assert len(leaves) == len(list(model.parameters())) and opt.lr(steps) == 0.0


@pytest.fixture(scope="module")
def qat_case(case):
    """The case's variables with the `max` scales of one QDQ forward (the
    recipe of tests/test_torch_qat.py)."""
    ranks, image, boxes, labels, variables = case
    jax_policy.set_quant_exclude(())
    _, mut = jax.jit(lambda v, *a: JaxBEVDet(jax_micro(quant=True)).apply(
        v, *a, mutable=["amax_stats"]))(variables, image, *ranks)
    return amax_to_quant(mut["amax_stats"])


def _nudged(model, seed, eps):
    """A copy of `model` whose stem BatchNorm weight moved by `eps`
    relative: a float32 change on the main path behind the first QDQ site
    (the image itself enters a QDQ site, whose rounding absorbs a 1e-7
    change of it)."""
    import copy

    nudged = copy.deepcopy(model)
    w = nudged.img_backbone.stem_bn.weight
    noise = np.random.default_rng(seed).standard_normal(tuple(w.shape))
    with torch.no_grad():
        w.mul_(1 + eps * torch.from_numpy(noise).float())
    return nudged


def test_qdq_step_matches_jax(case, qat_case):
    """The QDQ step against the JAX step with the same scales, at the bars
    of tests/test_torch_qat.py: a QDQ step is chaotic (one ulp moves an
    activation across a rounding boundary, a whole step), so each loss term
    and the whole gradient stay within 3 times the largest move of three
    perturbations of the port's own step.  The perturbation is of the stem
    BatchNorm's weight (`_nudged`), at the smallest of 1e-7, 1e-6 and 1e-5
    relative that flips a rounding: measured here, 1e-7 and 1e-6 flip none
    at micro and move nothing, 1e-5 moves the head maps by 5-9% (max
    relative), as far as the port stands from the JAX package (5-11%).
    The QDQ loss differs from the float loss."""
    ranks, image, boxes, labels, variables = case
    quant = qat_case
    want_m, want_g = _jax_loss_and_grads(jax_micro(quant=True), variables, image, ranks, boxes,
                                         labels, quant)
    model = BEVDet(bevdet_micro(quant=True))
    model.load_state_dict(params_from_jax({**variables, "quant": quant}), strict=True)
    check_quant_scales(model)
    got_m, got_g = _port_loss_and_grads(model.train(), image, ranks, boxes, labels)
    names = list(got_g)
    want_g = {n: w.numpy() for n, w in want_g.items()}
    assert set(want_g) == set(names)

    def l2(a, b):
        return np.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names)
                       / sum((b[n] ** 2).sum() for n in names))

    for eps in (1e-7, 1e-6, 1e-5):
        moves = []
        for seed in range(3):
            m, g = _port_loss_and_grads(_nudged(model, seed, eps), image, ranks, boxes, labels)
            moves.append(({k: abs(float(m[k]) - float(got_m[k])) for k in
                           ("loss_heatmap", "loss_bbox")}, l2(g, got_g)))
        if max(sum(mv[0].values()) for mv in moves) > 0:  # a rounding flipped
            break
    for k in ("loss_heatmap", "loss_bbox"):
        bar = 3 * max(mv[0][k] for mv in moves)
        assert abs(float(got_m[k]) - float(want_m[k])) <= bar + 1e-5 * abs(float(want_m[k])), k
    assert all(np.isfinite(g).all() for g in got_g.values())
    assert l2(got_g, want_g) <= 3 * max(mv[1] for mv in moves)
    assert max(mv[1] for mv in moves) > 1e-3  # the chaos the bar is made of is there
    float_m, _ = _port_loss_and_grads(_port_model(bevdet_micro(), variables), image, ranks,
                                      boxes, labels)
    assert abs(float(float_m["loss"]) - float(got_m["loss"])) > 1e-6
