"""The port's training pieces against the JAX package, on the CPU: losses and
match costs, the Hungarian assigner, the DETR loss with its gradients, the
optimizer against the optax chain, and the plain versions' VJPs (the
backward of every CUDA kernel) against `jax.vjp` of the JAX plain ops."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from bevformer_tensorrt_tpu.ops.attention import qkv as jax_qkv
from bevformer_tensorrt_tpu.ops.dcn import _dcn_xla
from bevformer_tensorrt_tpu.ops.msda import multi_scale_deformable_attn as jax_msda
from bevformer_tensorrt_tpu.train import losses as jax_losses
from bevformer_tensorrt_tpu.train.assigner import hungarian_assign as jax_hungarian
from bevformer_tensorrt_tpu.train.step import bevformer_detr_loss as jax_detr_loss
from bevformer_tensorrt_tpu.train.step import make_optimizer as jax_make_optimizer
from bevformer_tensorrt_tpu_torch.models.backbones.resnet import DeformConv2d
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops.attention import qkv_plain
from bevformer_tensorrt_tpu_torch.ops.msda import multi_scale_deformable_attn_plain
from bevformer_tensorrt_tpu_torch.train import assigner, losses
from bevformer_tensorrt_tpu_torch.train.step import Optimizer, bevformer_detr_loss, warmup_cosine
from torch_port_helpers import rel

torch.set_num_threads(2)

NUM_CLASSES = 10


def gt_boxes(rng, n):
    """n metric boxes (cx, cy, cz, w, l, h, rot, vx, vy) inside tiny's range."""
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-45, 45, (n, 2))
    b[:, 2] = rng.uniform(-4, 2, n)
    b[:, 3:6] = rng.uniform(0.3, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.normal(size=(n, 2))
    return b


def t(a):
    return torch.from_numpy(np.array(a))


# ---- losses and match costs (1e-6) ------------------------------------------

def _loss_inputs(rng):
    logits = (rng.standard_normal((30, NUM_CLASSES)) * 3).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES + 1, 30).astype(np.int32)  # NUM_CLASSES = background
    gt_labels = np.array([3, 0, 9, 5, -1, -1], np.int32)
    pred = rng.standard_normal((30, 10)).astype(np.float32)
    code = np.asarray(jax_losses.normalize_bbox(gt_boxes(rng, 6)))
    return logits, labels, gt_labels, pred, code


LOSS_CASES = {
    "normalize_bbox": lambda b, *_: (losses.normalize_bbox(t(b)),
                                     jax_losses.normalize_bbox(b)),
    "denormalize_bbox": lambda b, *_: (
        losses.denormalize_bbox(losses.normalize_bbox(t(b))),
        jax_losses.denormalize_bbox(jax_losses.normalize_bbox(b))),
    "sigmoid_ce": lambda _, lg, lab, *__: (
        losses.sigmoid_ce(t(lg), t((lab[:, None] == np.arange(NUM_CLASSES)).astype(np.float32))),
        jax_losses.optax_sigmoid_ce(lg, (lab[:, None] == np.arange(NUM_CLASSES)).astype(np.float32))),
    "sigmoid_focal_loss": lambda _, lg, lab, *__: (
        losses.sigmoid_focal_loss(t(lg), t(lab), NUM_CLASSES),
        jax_losses.sigmoid_focal_loss(lg, lab, NUM_CLASSES)),
    "focal_cls_cost": lambda _, lg, lab, gl, *__: (
        losses.focal_cls_cost(t(lg), t(gl)), jax_losses.focal_cls_cost(lg, gl)),
    "bbox_l1_cost": lambda _, lg, lab, gl, pred, code: (
        losses.bbox_l1_cost(t(pred), t(code)), jax_losses.bbox_l1_cost(pred, code)),
    "l1_loss": lambda _, lg, lab, gl, pred, code: (
        losses.l1_loss(t(pred[:6]), t(code)), jax_losses.l1_loss(pred[:6], code)),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_and_costs_match_jax(name, rng):
    boxes = gt_boxes(rng, 7)
    got, want = LOSS_CASES[name](boxes, *_loss_inputs(rng))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) < 1e-6


def test_normalize_roundtrip(rng):
    boxes = gt_boxes(rng, 9)
    back = losses.denormalize_bbox(losses.normalize_bbox(t(boxes))).numpy()
    np.testing.assert_allclose(back, boxes, atol=1e-4)


# ---- the Hungarian assigner -------------------------------------------------

@pytest.mark.parametrize("R,C", [(1, 5), (4, 50), (12, 40), (29, 300)])
def test_hungarian_matches_jax_and_scipy(R, C, rng):
    cost = (rng.normal(size=(R, C)) * rng.uniform(0.1, 5)).astype(np.float32)
    got = assigner.hungarian_assign(cost)
    np.testing.assert_array_equal(got, np.asarray(jax_hungarian(cost)))
    assert len(set(got.tolist())) == R
    ri, ci = linear_sum_assignment(cost)
    np.testing.assert_allclose(cost[np.arange(R), got].sum(), cost[ri, ci].sum(), rtol=1e-6)


@pytest.mark.parametrize("R,C,valid", [(6, 20, 3), (10, 30, 4), (16, 900, 5), (8, 16, 0)])
def test_hungarian_padding_rows_match_jax(R, C, valid, rng):
    """Constant (zero) padding rows: the real rows keep their optimum and the
    padding takes the lowest free columns, as the JAX solver gives them."""
    cost = rng.normal(size=(R, C)).astype(np.float32)
    cost[valid:] = 0.0
    mask = np.arange(R) < valid
    got = assigner.hungarian_assign(cost, mask)
    np.testing.assert_array_equal(got, np.asarray(jax_hungarian(cost)))
    assert len(set(got.tolist())) == R
    if valid:
        ri, ci = linear_sum_assignment(cost[:valid])
        np.testing.assert_allclose(cost[np.arange(valid), got[:valid]].sum(),
                                   cost[ri, ci].sum(), rtol=1e-6)


def test_assign_levels_is_one_round_trip(rng):
    """[N, L, R, C] costs with per-sample padding -> the per-matrix answer."""
    costs = rng.normal(size=(2, 3, 5, 40)).astype(np.float32)
    valid = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)
    got = assigner.assign_levels(t(costs), t(valid))
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 3, 5)
    for n in range(2):
        for lvl in range(3):
            np.testing.assert_array_equal(
                got[n, lvl].numpy(), assigner.hungarian_assign(costs[n, lvl], valid[n]))


# ---- the DETR loss and its gradients (1e-5) ---------------------------------

def _detr_case(rng, L=3, nq=40, non_finite=False):
    classes = (rng.standard_normal((L, 1, nq, NUM_CLASSES)) * 2).astype(np.float32)
    coords = rng.standard_normal((L, 1, nq, 10)).astype(np.float32)
    coords[..., :2] *= 30
    boxes = gt_boxes(rng, 8)
    labels = np.array([1, 4, 4, 0, 9, 2, -1, -1], np.int32)  # two padded rows
    boxes[6:] = 0.0
    if non_finite:
        boxes[2, 7] = np.nan  # a velocity target, as nuScenes has them
    return classes, coords, boxes, labels


@pytest.mark.parametrize("non_finite", [False, True])
def test_detr_loss_and_gradients_match_jax(non_finite, rng):
    """The matching on every level, the sums, num_pos and the gradients
    against jax.value_and_grad.  A non-finite target is masked out of the
    gradient by `code_ok`; the JAX loss multiplies by the mask, so the bbox
    sum is NaN there in both packages (the loader zeroes NaN velocities)."""
    classes, coords, boxes, labels = _detr_case(rng, non_finite=non_finite)

    def jax_total(c, o):
        d = jax_detr_loss(c, o, boxes, labels, NUM_CLASSES)
        return d["cls_sum"] + d["bbox_sum"], d

    (want, jd), (jg_c, jg_o) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(classes), jnp.asarray(coords))
    c, o = t(classes).requires_grad_(), t(coords).requires_grad_()
    d = bevformer_detr_loss(c, o, t(boxes), t(labels), NUM_CLASSES)
    (d["cls_sum"] + d["bbox_sum"]).backward()
    assert float(d["num_pos"]) == float(jd["num_pos"]) == 6 * 3
    assert rel(d["cls_sum"].detach().numpy(), np.asarray(jd["cls_sum"])) < 1e-5
    if non_finite:
        assert np.isnan(float(d["bbox_sum"].detach())) and np.isnan(float(jd["bbox_sum"]))
    else:
        assert rel(d["bbox_sum"].detach().numpy(), np.asarray(jd["bbox_sum"])) < 1e-5
        assert rel(float((d["cls_sum"] + d["bbox_sum"]).detach()), float(want)) < 1e-5
    assert np.isfinite(c.grad.numpy()).all() and np.isfinite(o.grad.numpy()).all()
    assert rel(c.grad.numpy(), np.asarray(jg_c)) < 1e-5
    assert rel(o.grad.numpy(), np.asarray(jg_o)) < 1e-5


def test_detr_loss_matching_matches_jax(rng):
    """Each level's row2col from the port's costs against the JAX solver on
    the JAX costs."""
    from bevformer_tensorrt_tpu_torch.train.step import match_costs

    classes, coords, boxes, labels = _detr_case(rng)
    code = jax_losses.normalize_bbox(boxes)
    costs = match_costs(t(classes), t(coords), losses.normalize_bbox(t(boxes)), t(labels))
    got = assigner.assign_levels(costs[None], t(labels >= 0)[None])[0].numpy()
    for lvl in range(classes.shape[0]):
        jc = (jax_losses.focal_cls_cost(classes[lvl, 0], labels, weight=2.0)
              + jax_losses.bbox_l1_cost(coords[lvl, 0], code, weight=0.25)).T
        jc = jnp.where((labels >= 0)[:, None], jc, 0.0)
        assert rel(costs[lvl].numpy(), np.asarray(jc)) < 1e-6
        np.testing.assert_array_equal(got[lvl], np.asarray(jax_hungarian(jc)))


# ---- the optimizer against the optax chain ---------------------------------

class _Tree(torch.nn.Module):
    """Leaves under `img_backbone` and under a head, as the model names them,
    drawn at the scale of LeCun-initialised weights."""

    def __init__(self, rng):
        super().__init__()
        self.img_backbone = torch.nn.Linear(6, 5)
        self.head = torch.nn.Linear(5, 3)
        self.emb = torch.nn.Parameter(torch.zeros(4, 2))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(t((rng.standard_normal(tuple(p.shape)) * 0.2).astype(np.float32)))


def _jax_tree(module):
    return {n: jnp.asarray(p.detach().numpy()) for n, p in module.named_parameters()}


def _grads(rng, module, steps):
    """Seeded gradients; steps 2, 5 and 9 large enough that the clip acts."""
    out = []
    for s in range(steps):
        scale = 40.0 if s in (2, 5, 9) else 0.5
        out.append({n: (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
                    for n, p in module.named_parameters()})
    return out


@pytest.mark.parametrize("total,warmup", [(10, 3), (10, 0), (None, 0)])
def test_optimizer_matches_optax_chain(total, warmup, rng):
    """12 steps of the same seeded gradients through the optax chain and the
    port's optimizer (with a total of 10 the last steps sit at the end
    value; without one the rate is constant; the clip acts at three steps).
    The peak rate 1e-2 moves each parameter by ~1e-2 a step; optax rounds b1
    and b2 to float32 (1 - 0.999 is off by 1.3e-5 relative), which moves a
    step by ~1e-7, so the bar is 1e-6."""
    module = _Tree(rng)
    grads = _grads(rng, module, 12)
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads]
    assert sum(n > 35 for n in norms) >= 3 and sum(n < 35 for n in norms) >= 3

    tx = jax_make_optimizer(learning_rate=1e-2, total_steps=total, warmup_steps=warmup)
    params = _jax_tree(module)
    state = tx.init(params)
    opt = Optimizer(module, learning_rate=1e-2, total_steps=total, warmup_steps=warmup)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    for s, gs in enumerate(grads):
        updates, state = tx.update({n: jnp.asarray(g) for n, g in gs.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in module.named_parameters():
            p.grad = t(gs[n]).clone()
        opt.step()
        for n, p in module.named_parameters():
            assert np.abs(p.detach().numpy() - np.asarray(params[n])).max() < 1e-6, (s, n)
            if s == 0 and warmup:  # the schedule's rate at count 0 is 0
                assert torch.equal(p.detach(), before[n]), n
    assert opt.count == 12


def test_optimizer_backbone_takes_a_tenth(rng):
    """One step at a constant rate from zero moments: the backbone's update
    is 0.1x what the same gradient gives a head parameter, decay included."""
    module = _Tree(rng)
    with torch.no_grad():
        module.head.weight.copy_(module.img_backbone.weight[:3, :5])
    opt = Optimizer(module, learning_rate=1e-2)
    w_b, w_h = module.img_backbone.weight[:3, :5].detach().clone(), module.head.weight.detach().clone()
    g = t(rng.standard_normal((3, 5)).astype(np.float32))
    for p in module.parameters():
        p.grad = torch.zeros_like(p)
    module.img_backbone.weight.grad[:3, :5] = g
    module.head.weight.grad.copy_(g)
    opt.step()
    d_b = module.img_backbone.weight[:3, :5].detach() - w_b
    d_h = module.head.weight.detach() - w_h
    torch.testing.assert_close(d_b, 0.1 * d_h, rtol=1e-4, atol=1e-9)


def test_warmup_cosine_is_optax_schedule():
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-4, 3, 10, end_value=2e-4 * 1e-3)
    for count in range(14):  # optax evaluates in float32
        assert abs(warmup_cosine(count, 2e-4, 3, 10) - float(sched(count))) < 2e-4 * 1e-6


def test_kept_dcn_weight_matrix_follows_the_optimizer(rng):
    """DeformConv2d keys its kept matrix on the weight's version: the
    optimizer's in-place update moves it, so the next forward takes the
    updated weight."""
    m = DeformConv2d(32, 16)
    with torch.no_grad():
        m.weight.copy_(t(rng.standard_normal((16, 32, 3, 3)).astype(np.float32)))
    opt = Optimizer(m, learning_rate=0.1)
    kept = m.weight_matrix(torch.bfloat16)
    version = m.weight._version
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert m.weight._version != version
    fresh = m.weight_matrix(torch.bfloat16)
    assert not torch.equal(fresh, kept)
    assert torch.equal(fresh, dcn_ops.dcn_weight_matrix(m.weight.detach(), torch.bfloat16))


def test_parameter_without_gradient_still_decays(rng):
    """optax updates every leaf: a parameter the loss does not reach takes a
    zero gradient, so only the weight decay moves it."""
    module = _Tree(rng)
    opt = Optimizer(module, learning_rate=1e-2, weight_decay=0.5)
    before = module.emb.detach().clone()
    for n, p in module.named_parameters():
        p.grad = None if n == "emb" else torch.ones_like(p)
    opt.step()
    torch.testing.assert_close(module.emb.detach(), before * (1 - 1e-2 * 0.5), rtol=1e-6, atol=0)


# ---- the plain versions' VJPs: the backward of every kernel (1e-5) ----------

def _vjp_pair(port_fn, jax_fn, arrays, rng):
    """Gradients of <port_fn(*arrays), cot> against those of jax.vjp."""
    want_out, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    cot = rng.standard_normal(want_out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    ins = [t(a).requires_grad_() for a in arrays]
    out = port_fn(*ins)
    assert rel(out.detach().numpy(), np.asarray(want_out)) < 1e-5
    got = torch.autograd.grad(out, ins, t(cot))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


MSDA_VJP_CASES = {
    "L1_ppg4": (((10, 12),), 2, 30, 4, 8, 8, 4),
    "L4_ppg1": (((16, 20), (8, 10), (4, 5), (2, 3)), 1, 25, 2, 8, 4, 1),
}


@pytest.mark.parametrize("case", sorted(MSDA_VJP_CASES))
def test_msda_plain_vjp_matches_jax(case, rng):
    shapes, bs, nq, heads, ch, P, ppg = MSDA_VJP_CASES[case]
    L = len(shapes)
    keys = sum(h * w for h, w in shapes)
    arrays = (rng.standard_normal((bs, keys, heads, ch)).astype(np.float32),
              rng.uniform(-0.1, 1.1, (bs, nq, 1, ppg * 2)).astype(np.float32),
              (rng.standard_normal((bs, nq, heads, L * P * 2)) * 3).astype(np.float32),
              rng.standard_normal((bs, nq, heads, L * P)).astype(np.float32))
    got, want = _vjp_pair(lambda *a: multi_scale_deformable_attn_plain(*a, shapes),
                          lambda *a: jax_msda(*a, shapes), arrays, rng)
    for name, g, w in zip(("value", "reference_points", "offsets", "logits"), got, want):
        assert rel(g, w) < 1e-5, name


@pytest.mark.parametrize("Lq,Lk,d", [(40, 40, 32), (17, 23, 8)])
def test_qkv_plain_vjp_matches_jax(Lq, Lk, d, rng):
    arrays = (rng.standard_normal((3, Lq, d)).astype(np.float32),
              rng.standard_normal((3, Lk, d)).astype(np.float32),
              rng.standard_normal((3, Lk, d)).astype(np.float32))
    got, want = _vjp_pair(qkv_plain, jax_qkv, arrays, rng)
    for name, g, w in zip("qkv", got, want):
        assert rel(g, w) < 1e-5, name


@pytest.mark.parametrize("stride,dg", [(1, 1), (2, 2)])
def test_dcn_plain_vjp_matches_jax(stride, dg, rng):
    N, Cin, H, W, Cout = 2, 8, 9, 11, 6
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    arrays = (rng.standard_normal((N, Cin, H, W)).astype(np.float32),
              (rng.standard_normal((N, 2 * dg * 9, Ho, Wo)) * 1.5).astype(np.float32),
              rng.random((N, dg * 9, Ho, Wo)).astype(np.float32),
              (rng.standard_normal((Cout, Cin, 3, 3)) * 0.1).astype(np.float32))
    got, want = _vjp_pair(
        lambda x, o, m, w: dcn_ops.modulated_deform_conv2d_plain(
            x, o, m, w, None, stride, 1, 1, 1, dg),
        lambda x, o, m, w: _dcn_xla(x, o, m, w, stride, 1, 1, 1, dg), arrays, rng)
    for name, g, w in zip(("x", "offset", "mask", "weight"), got, want):
        assert rel(g, w) < 1e-5, name
