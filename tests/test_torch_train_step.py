"""The port's BEVFormer training step against the JAX package on the CPU
(micro, one encoder and one decoder layer): the matching, the loss and every
parameter's gradient, the temporal step, the train CLI with its checkpoint
read back by the evaluator, and the guard that keeps the CUDA kernels
differentiable (the autograd Function driven on the CPU with stub launches
that compute the forward outside autograd, as a kernel writing into
`torch.empty` does)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.train import losses as jax_losses
from bevformer_tensorrt_tpu.train.assigner import hungarian_assign as jax_hungarian
from bevformer_tensorrt_tpu.train.step import make_temporal_train_step, make_train_step
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import int8_matmul as int8_ops
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig
from bevformer_tensorrt_tpu_torch.tools import evaluate, train
from bevformer_tensorrt_tpu_torch.train import assign_levels, loss_fn, normalize_bbox
from bevformer_tensorrt_tpu_torch.train.step import match_costs, temporal_loss_fn
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import SYNTH_INFOS, make_synthetic_set, random_variables, rel

torch.set_num_threads(2)

OVER = dict(encoder_layers=1, decoder_layers=1)
NUM_CLASSES = 10
T = 2  # the temporal step's queue


def _gt(rng, G=6, valid=4):
    boxes = np.zeros((G, 9), np.float32)
    boxes[:valid, :2] = rng.uniform(-40, 40, (valid, 2))
    boxes[:valid, 2] = rng.uniform(-3, 1, valid)
    boxes[:valid, 3:6] = rng.uniform(0.5, 4, (valid, 3))
    boxes[:valid, 6] = rng.uniform(-np.pi, np.pi, valid)
    boxes[:valid, 7:] = rng.normal(size=(valid, 2))
    labels = np.full(G, -1, np.int32)
    labels[:valid] = rng.integers(0, NUM_CLASSES, valid)
    return boxes, labels


@pytest.fixture(scope="module")
def case():
    """(cfg, jcfg, flax model, variables, single-frame batch, temporal batch)."""
    rng = np.random.default_rng(11)
    jcfg = jax_configs.bevformer_micro(msda_impl="jnp", **OVER)
    cfg = bevformer_micro(**OVER)
    l2i = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    images = rng.standard_normal((1, T, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32)
    can_bus = (rng.standard_normal((1, T, cfg.can_bus_dims)) * 0.5).astype(np.float32)
    can_bus[:, 0, :3] = can_bus[:, 0, -1] = 0.0  # the clip's first frame: no delta
    boxes, labels = _gt(rng)
    temporal = dict(image=images, can_bus=can_bus,
                    lidar2img=np.broadcast_to(l2i[None], (1, T) + l2i.shape).copy(),
                    gt_boxes=boxes[None], gt_labels=labels[None])
    single = dict(image=images[:, -1], can_bus=can_bus[:, -1], lidar2img=l2i[None],
                  gt_boxes=boxes[None], gt_labels=labels[None])
    nq = cfg.bev_h * cfg.bev_w
    model = JaxBEVFormer(jcfg)
    variables = random_variables(model, rng, images[0, -1][None],
                                 np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
                                 can_bus[0, -1], l2i)
    return cfg, jcfg, model, variables, single, temporal


# the optax "optimizer" whose state after one update is the gradient itself
CAPTURE = optax.GradientTransformation(
    lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    lambda updates, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, updates),
                                         updates))


def _jax_step(make, model, variables, batch, **kw):
    """(metrics, gradients in the port's names) of the JAX train step."""
    step = jax.jit(make(model, NUM_CLASSES, CAPTURE, **kw))
    params = variables["params"]
    _, grads, metrics = step(params, variables["batch_stats"], CAPTURE.init(params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    return metrics, params_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})


def _port_model(cfg, variables):
    model = BEVFormer(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _port_grads(model, fn, batch):
    model.zero_grad(set_to_none=True)
    loss, metrics = fn(model, _tensors(batch))
    loss.backward()
    return metrics, {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                     for n, p in model.named_parameters()}


def test_matching_matches_jax(case):
    """Every decoder level's assignment from the port's outputs is the JAX
    solver's on the JAX outputs."""
    cfg, jcfg, model, variables, single, _ = case
    nq = cfg.bev_h * cfg.bev_w
    args = (single["image"], np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
            single["can_bus"][0], single["lidar2img"][0])
    _, jcls, jcoords = jax.jit(model.apply)(variables, *args)
    port = _port_model(cfg, variables)
    with torch.no_grad():
        _, cls, coords = port(*(torch.from_numpy(np.asarray(a)) for a in args))
    assert rel(cls.numpy(), np.asarray(jcls)) < 1e-5 and rel(coords.numpy(), np.asarray(jcoords)) < 1e-5
    boxes, labels = single["gt_boxes"][0], single["gt_labels"][0]
    costs = match_costs(cls, coords, normalize_bbox(torch.from_numpy(boxes)),
                        torch.from_numpy(labels))
    got = assign_levels(costs[None], torch.from_numpy(labels >= 0)[None])[0].numpy()
    code = jax_losses.normalize_bbox(boxes)
    valid = labels >= 0
    for lvl in range(cfg.decoder_layers):
        jc = (jax_losses.focal_cls_cost(jcls[lvl, 0], labels, weight=2.0)
              + jax_losses.bbox_l1_cost(jcoords[lvl, 0], code, weight=0.25)).T
        want = np.asarray(jax_hungarian(jnp.where(valid[:, None], jc, 0.0)))
        np.testing.assert_array_equal(got[lvl][valid], want[valid])


# A key projection's bias adds q.b to every logit of a query, which the
# softmax ignores: its gradient is 0, and both packages give float noise.
ZERO_GRADIENT = ("self_attn.k_proj.bias",)


def test_loss_and_every_gradient_match_jax(case):
    """The JAX `loss_fn` through `jax.value_and_grad` (its train step's
    gradient) against the port's loss and backward: the loss within 1e-5;
    each parameter's gradient within 1e-4 of its leaf's max |g|, or within
    twice what a 1e-7 relative change of the image moves the port's own
    gradient where that is more.  Measured here (CPU): 14 of 245 leaves, all
    in the R50's stem and first stages, sit at 1.0e-4 to 6.2e-4 from JAX, and
    the image noise moves the port's own gradient of each of them by the
    same amount (the network's ReLU and max-pool choices, not the port);
    over all leaves the relative L2 error is 4.9e-6, and 4.9e-6 under the
    noise."""
    cfg, jcfg, model, variables, single, _ = case
    want_m, want_g = _jax_step(make_train_step, model, variables, single)
    port = _port_model(cfg, variables)
    got_m, got_g = _port_grads(port, loss_fn, single)
    noisy = dict(single)
    noise = np.random.default_rng(3).standard_normal(single["image"].shape)
    noisy["image"] = (single["image"] * (1 + 1e-7 * noise)).astype(np.float32)
    _, moved = _port_grads(port, loss_fn, noisy)
    for k in ("loss", "loss_cls", "loss_bbox"):
        assert rel(float(got_m[k]), float(want_m[k])) < 1e-5, k
    assert float(got_m["num_pos"]) == float(want_m["num_pos"]) == 4 * cfg.decoder_layers
    assert set(got_g) == set(want_g)
    want_g = {n: w.numpy() for n, w in want_g.items()}
    top = max(np.abs(w).max() for w in want_g.values())
    at_1e4, num, den = 0, 0.0, 0.0
    for name, w in want_g.items():
        if name.endswith(ZERO_GRADIENT):
            assert np.abs(w).max() < 1e-5 * top and np.abs(got_g[name]).max() < 1e-5 * top
            continue
        scale = np.abs(w).max()
        err = np.abs(got_g[name] - w).max() / scale
        chaos = np.abs(moved[name] - got_g[name]).max() / scale
        assert err <= max(1e-4, 2 * chaos), (name, err, chaos)
        at_1e4 += err <= 1e-4
        num += ((got_g[name] - w) ** 2).sum()
        den += (w ** 2).sum()
    assert at_1e4 >= 0.9 * len(want_g)
    assert np.sqrt(num / den) < 1e-5
    assert any(n.startswith("img_backbone.") and np.abs(w).max() > 0 for n, w in want_g.items())


def test_temporal_step_matches_jax(case):
    """The temporal step (T = 2: one no-grad history pass, then the trained
    frame) against the JAX temporal step, and different from the
    single-frame loss on the same last frame."""
    cfg, jcfg, model, variables, single, temporal = case
    want_m, _ = _jax_step(make_temporal_train_step, model, variables, temporal, queue_length=T)
    port = _port_model(cfg, variables)
    got_m, got_g = _port_grads(port, temporal_loss_fn, temporal)
    assert rel(float(got_m["loss"]), float(want_m["loss"])) < 1e-5
    single_loss, _ = loss_fn(port, _tensors(single))
    assert abs(float(got_m["loss"]) - float(single_loss.detach())) > 1e-6
    assert np.abs(got_g["img_backbone.stem_conv.weight"]).max() > 0


def test_train_cli_round_trip(tmp_path):
    """tools/train.py micro for 2 steps, then --temporal from its checkpoint;
    the .pth loads in tools/evaluate.py --checkpoint."""
    root = make_synthetic_set(tmp_path / "set")
    common = ["--infos", str(root / SYNTH_INFOS), "--data-root", str(root), "--device", "cpu",
              "--log-every", "1"]
    first = train.main(["micro", *common, "--steps", "2", "--out", str(tmp_path / "a.pth")])
    assert len(first.metrics) == 2 and all(np.isfinite(m["loss"]) for m in first.metrics)
    assert first.optimizer.count == 2
    second = train.main(["micro", *common, "--steps", "2", "--temporal", "--queue-length", "2",
                         "--resume", str(tmp_path / "a.pth"), "--out", str(tmp_path / "b.pth")])
    assert all(np.isfinite(m["loss"]) for m in second.metrics)
    res = evaluate.main(["micro", "--infos", str(root / SYNTH_INFOS), "--data-root", str(root),
                         "--device", "cpu", "--checkpoint", str(tmp_path / "b.pth")])
    sd = res.engine.model.state_dict()
    for name, p in second.model.state_dict().items():
        assert torch.equal(sd[name].cpu(), p.cpu()), name
    assert all(np.isfinite(v) for v in res.metrics.values())


def test_train_cli_refuses_without_cuda(tmp_path, monkeypatch):
    """Without CUDA the trainer raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["micro", "--infos", str(tmp_path / "none.pkl")])


# ---- the guard: kernel launches stay differentiable -------------------------

def _no_grad(fn):
    """A stand-in for a kernel launch on the CPU: the same forward, computed
    outside autograd, as the kernel writes into a tensor made by torch.empty."""
    def launch(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return launch


def _msda_stub(value, ref, off, attn, shapes, int8_table=None):
    plain = (msda_ops.multi_scale_deformable_attn_int8_plain if int8_table is not None
             else msda_ops.multi_scale_deformable_attn_plain)
    return _no_grad(plain)(value, ref, off, attn, shapes)


def _flash_stub(q, k, v, heads=1):
    return _no_grad(attn_ops.qkv_heads_plain)(q, k, v, heads)


def _route_through_functions(monkeypatch, ops):
    """On the CPU, send the model's MSDA and / or flash calls through the
    wrappers' autograd Function with stub launches."""
    if "msda" in ops:
        monkeypatch.setattr(msda_ops, "_msda_cuda", _msda_stub)
        monkeypatch.setattr(msda_ops, "multi_scale_deformable_attn",
                            lambda v, r, o, a, s: msda_ops._msda_kernel(v, r, o, a, tuple(s), False))
    if "flash" in ops:
        monkeypatch.setattr(attn_ops, "_flash_cuda", _flash_stub)
        monkeypatch.setattr(attn_ops, "flash_attention",
                            lambda q, k, v: attn_ops._flash_heads(q, k, v))


FED_BY = {  # what each op's gradient must reach, by parameter name
    "msda": ("self_attn.value_proj.weight", "self_attn.sampling_offsets.weight",
             "self_attn.attention_weights.weight",
             "cross_attn.deformable_attention.value_proj.weight",
             "cross_attn.deformable_attention.sampling_offsets.weight",
             "decoder.layer0.cross_attn.value_proj.weight",
             "decoder.layer0.cross_attn.sampling_offsets.weight", "img_backbone.stem_conv.weight"),
    "flash": ("self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight"),
}


def _grads_by_suffix(grads, suffix):
    return [g for n, g in grads.items() if n.endswith(suffix)]


@pytest.mark.parametrize("ops", [("msda",), ("flash",), ("msda", "flash")])
def test_kernel_function_keeps_the_gradient(ops, case, monkeypatch):
    """Through the Function, every parameter's gradient equals the plain
    path's, and those feeding the op are non-zero.  Without it (the stub
    launch called directly) they are cut off: the failure the Function
    prevents."""
    cfg, _, _, variables, single, _ = case
    port = _port_model(cfg, variables)
    _, want = _port_grads(port, loss_fn, single)
    with monkeypatch.context() as m:
        _route_through_functions(m, ops)
        _, got = _port_grads(port, loss_fn, single)
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30), name
    for op in ops:
        for suffix in FED_BY[op]:
            found = _grads_by_suffix(got, suffix)
            assert found and all(np.abs(g).max() > 0 for g in found), suffix
    with monkeypatch.context() as m:  # the stub alone: no grad_fn, no gradient upstream
        if "msda" in ops:
            m.setattr(msda_ops, "multi_scale_deformable_attn",
                      lambda v, r, o, a, s: _msda_stub(v, r, o, a, s))
        if "flash" in ops:
            m.setattr(attn_ops, "flash_attention", lambda q, k, v: _flash_stub(q, k, v))
        _, cut = _port_grads(port, loss_fn, single)
    op = ops[0]
    assert all(np.abs(g).max() == 0 for g in _grads_by_suffix(cut, FED_BY[op][0]))


def _grads_of(fn, inputs):
    ins = [None if a is None else a.clone().requires_grad_() for a in inputs]
    out = fn(*ins)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(out.shape).astype(np.float32))
    out.backward(cot.to(out.dtype))
    return out, [None if a is None else a.grad for a in ins]


def _msda_inputs(rng):
    shapes = ((10, 12),)
    return shapes, [torch.from_numpy(a) for a in (
        rng.standard_normal((2, 120, 4, 8)).astype(np.float32),
        rng.uniform(-0.1, 1.1, (2, 30, 1, 8)).astype(np.float32),
        (rng.standard_normal((2, 30, 4, 16)) * 3).astype(np.float32),
        rng.standard_normal((2, 30, 4, 8)).astype(np.float32))]


@pytest.mark.parametrize("int8", [False, True])
def test_msda_function_gradient_is_the_float_plain_vjp(int8, rng, monkeypatch):
    """The MSDA Function with a stub launch: output with a grad_fn, the
    forward the stub's, gradients those of the floating-point plain version
    (straight-through for the int8 table)."""
    monkeypatch.setattr(msda_ops, "_msda_cuda", _msda_stub)
    shapes, inputs = _msda_inputs(rng)
    out, got = _grads_of(lambda *a: msda_ops._msda_kernel(*a, shapes, True if int8 else None),
                         inputs)
    assert out.grad_fn is not None
    _, want = _grads_of(lambda *a: msda_ops.multi_scale_deformable_attn_plain(*a, shapes), inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_function_gradient_is_the_qkv_plain_vjp(int8, rng, monkeypatch):
    monkeypatch.setattr(attn_ops, "_flash_cuda", _flash_stub)
    monkeypatch.setattr(attn_ops, "_flash_int8_cuda",
                        lambda q, k, v, operands, heads: _no_grad(attn_ops.qkv_heads_plain)(q, k, v,
                                                                                         heads))
    inputs = [torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(np.float32))
              for _ in range(3)]
    fn = attn_ops._flash_int8_heads if int8 else attn_ops._flash_heads
    out, got = _grads_of(lambda q, k, v: fn(q, k, v, heads=2), inputs)
    assert out.grad_fn is not None
    _, want = _grads_of(lambda q, k, v: attn_ops._split_heads(attn_ops.qkv_plain, q, k, v, 2),
                        inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _dcn_inputs(rng, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in (
        rng.standard_normal((2, 32, 9, 11)).astype(np.float32),
        (rng.standard_normal((2, 18, 9, 11)) * 1.5).astype(np.float32),
        rng.random((2, 9, 9, 11)).astype(np.float32),
        (rng.standard_normal((16, 32, 3, 3)) * 0.1).astype(np.float32))]


def test_dcn_im2col_route_gradient_is_the_plain_vjp(rng, monkeypatch):
    """The float32 map's route with a stub im2col launch: gradients of x,
    offset, mask and weight equal the plain op's autograd."""
    def im2col_stub(x, table_scale, offset, mask, *static):
        return _no_grad(dcn_ops.deform_im2col_plain)(x, offset, mask, *static)

    monkeypatch.setattr(dcn_ops, "_launch_im2col", im2col_stub)
    inputs = _dcn_inputs(rng)
    out, got = _grads_of(lambda x, o, m, w: dcn_ops._dcn_im2col_route(
        x, o, m, w, None, 1, 1, 1, 1, 1, "NCHW"), inputs)
    assert out.grad_fn is not None
    _, want = _grads_of(lambda x, o, m, w: dcn_ops.modulated_deform_conv2d_plain(x, o, m, w),
                        inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_dcn_fused_gradient_is_the_float32_plain_vjp(int8, rng, monkeypatch):
    """The fused op (bfloat16 map, or the int8 table of a float32 map) with a
    stub launch: gradients are the float32 plain op's, cast to the inputs'
    dtypes (straight-through for the int8 table)."""
    def fused_stub(x, offset, mask, weight, bias, *static):
        plain = dcn_ops.modulated_deform_conv2d_int8_plain if static[-2] else (
            dcn_ops.modulated_deform_conv2d_plain)
        out = _no_grad(plain)(x, offset, mask, weight, bias, *static[:6])
        return out, lambda: None

    monkeypatch.setattr(dcn_ops, "fused_launcher", fused_stub)
    dtype = torch.float32 if int8 else torch.bfloat16
    inputs = _dcn_inputs(rng, dtype)
    out, got = _grads_of(lambda x, o, m, w: dcn_ops._dcn_cuda(
        x, o, m, w, None, 1, 1, 1, 1, 1, "NCHW", int8), inputs)
    assert out.grad_fn is not None and out.dtype == dtype
    _, want = _grads_of(lambda x, o, m, w: dcn_ops.modulated_deform_conv2d_plain(
        x.float(), o.float(), m.float(), w.float()).to(dtype), inputs)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_int8_matmul_refuses_gradients():
    x = torch.ones(4, 16, dtype=torch.int8)
    w = torch.ones(3, 16, dtype=torch.int8)
    w_scale = torch.full((3,), 0.5, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        int8_ops.int8_matmul(x, w, 0.25, w_scale)
    with pytest.raises(RuntimeError, match="no gradient"):
        int8_ops.int8_matmul(x, w, torch.tensor(0.25, requires_grad=True), w_scale.detach())
    with torch.no_grad():
        out = int8_ops.int8_matmul(x, w, 0.25, w_scale)
    torch.testing.assert_close(out, torch.full((4, 3), 16 * 0.125))
