"""Quantization-aware training of the port against the JAX package on the
CPU (micro, one encoder and one decoder layer): a dense and a conv module's
QAT gradients exactly, the QAT step's loss and gradients against
`make_train_step(..., quant_vars=...)` with the same scales, the guard
against a live site without a scale, and the train CLI's
`--quant-scales` with its `.pth` read back by `tools/evaluate.py --quant
int8`, whose int8 weights are folded anew from the QAT weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.train.step import make_train_step
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense
from bevformer_tensorrt_tpu_torch.quant.calibrate import qdq_sites
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales, quantize_weight
from bevformer_tensorrt_tpu_torch.quant.observers import CalibrationResult
from bevformer_tensorrt_tpu_torch.quant.policy import load_policy
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    load_bevformer_checkpoint,
    load_torch_checkpoint,
    upstream_layout,
)
from bevformer_tensorrt_tpu_torch.tools import calibrate, evaluate, train
from bevformer_tensorrt_tpu_torch.train import Optimizer, check_quant_scales, loss_fn, train_step
from bevformer_tensorrt_tpu_torch.weights import init_weights, params_from_jax
from test_torch_train_step import OVER, ZERO_GRADIENT, _jax_step, _tensors
from test_torch_train_step import case  # noqa: F401  (the module's fixture)
from torch_port_helpers import (
    SYNTH_INFOS,
    amax_to_quant,
    make_synthetic_set,
    random_variables,
    rel,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def qat_case(case):  # noqa: F811
    """(cfg quant=True, flax QDQ model, variables, the "quant" collection of
    `max` scales from one forward's amax (tests/test_train.py's recipe),
    single-frame batch)."""
    cfg, jcfg, _, variables, single, _ = case
    from bevformer_tensorrt_tpu.configs import bevformer as jax_configs

    jmodel = JaxBEVFormer(jax_configs.bevformer_micro(msda_impl="jnp", quant=True, **OVER))
    nq = cfg.bev_h * cfg.bev_w
    args = (single["image"], np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
            single["can_bus"][0], single["lidar2img"][0])
    _, mut = jax.jit(lambda v, *a: jmodel.apply(v, *a, mutable=["amax_stats"]))(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}, *args)
    quant = amax_to_quant(mut["amax_stats"])
    return bevformer_micro(quant=True, **OVER), jmodel, variables, quant, single


def _port_qat_model(cfg, variables, quant):
    model = BEVFormer(cfg)
    model.load_state_dict(params_from_jax({**variables, "quant": quant}), strict=True)
    return model


def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, _tensors(batch))
    loss.backward()
    return metrics, {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                     for n, p in model.named_parameters()}


def _module_grads_pair(jax_module, port_module, rng, x, nchw):
    """One module with seeded weights and `max` scales from one forward
    (carried into the port): the gradients of sum(out * cot) with respect to
    the input and every parameter, JAX's (in the port's names) and the
    port's."""
    jx = np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if nchw else x
    variables = random_variables(jax_module, rng, jx)
    _, mut = jax_module.apply(variables, jx, mutable=["amax_stats"])
    quant = amax_to_quant(mut["amax_stats"])
    out = jax_module.apply({**variables, "quant": quant}, jx)
    cot = rng.standard_normal(out.shape).astype(np.float32)

    def f(params, xx):
        return jnp.sum(jax_module.apply({**variables, "params": params, "quant": quant}, xx)
                       * cot)

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], jx)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, gp)})
    want["input"] = np.asarray(gx).transpose(0, 3, 1, 2) if nchw else np.asarray(gx)
    port_module.load_state_dict(params_from_jax({**variables, "quant": quant}), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = port_module(xt)
    y.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2) if nchw else cot))
    got = {n: p.grad.numpy() for n, p in port_module.named_parameters()}
    got["input"] = xt.grad.numpy()
    return {k: np.asarray(v) for k, v in want.items()}, got


@pytest.mark.parametrize("which", ["ffn", "bottleneck"])
def test_qat_module_gradients_match_jax(which, rng):
    """Through a dense and a conv module with carried scales (their weights
    fake-quantized per output channel, activations at fixed scales,
    straight-through gradients): every gradient within 1e-5 of the JAX
    package's, as the floating-point modules' are."""
    from bevformer_tensorrt_tpu.models.backbones import resnet as jax_resnet
    from bevformer_tensorrt_tpu.models.layers import FFN as JaxFFN
    from bevformer_tensorrt_tpu_torch.models.backbones import resnet as port_resnet
    from bevformer_tensorrt_tpu_torch.models.layers import FFN

    if which == "ffn":
        x = rng.standard_normal((1, 50, 64)).astype(np.float32)
        want, got = _module_grads_pair(JaxFFN(64, 128, quant=True), FFN(64, 128, quant=True),
                                       rng, x, nchw=False)
    else:
        x = rng.standard_normal((2, 16, 10, 12)).astype(np.float32)
        want, got = _module_grads_pair(
            jax_resnet.Bottleneck(8, (2, 2), downsample=True, style="pytorch", quant=True),
            port_resnet.Bottleneck(16, 8, 2, True, "pytorch", quant=True), rng, x, nchw=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel(got[k], want[k]) < 1e-5, k
        assert np.abs(want[k]).max() > 0, k


def test_qat_step_matches_jax(qat_case):
    """The port's QDQ step against the JAX train step with `quant_vars`.
    End to end the two packages cannot agree to 1e-5: a float32 difference
    of one ulp moves an activation across a rounding boundary of a QDQ site,
    a whole step away, and the random-weight network spreads it
    (test_torch_quant_model.py::test_two_frames_match_jax).  Measured here:
    a 1e-7 relative change of the image moves the port's own QAT gradient by
    0.106 in the relative L2 norm and its classification loss by 8.9e-4,
    and the port stands 0.108 and 1.2e-3 from the JAX package.  So the bar
    is the port's own sensitivity: each loss term and the whole gradient
    within 3 times the largest move of three such image perturbations (the
    exact comparison is `test_qat_module_gradients_match_jax`)."""
    cfg, jmodel, variables, quant, single = qat_case
    want_m, want_g = _jax_step(make_train_step, jmodel, variables, single, quant_vars=quant)
    model = _port_qat_model(cfg, variables, quant)
    check_quant_scales(model)
    got_m, got_g = _grads(model, single)
    names = [n for n in got_g if not n.endswith(ZERO_GRADIENT)]
    want_g = {n: w.numpy() for n, w in want_g.items()}
    assert set(got_g) == set(want_g)

    def l2(a, b):
        return np.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names)
                       / sum((b[n] ** 2).sum() for n in names))

    moves = []
    for seed in range(3):
        noisy = dict(single)
        noise = np.random.default_rng(seed).standard_normal(single["image"].shape)
        noisy["image"] = (single["image"] * (1 + 1e-7 * noise)).astype(np.float32)
        m, g = _grads(model, noisy)
        moves.append(({k: abs(float(m[k]) - float(got_m[k])) for k in ("loss_cls", "loss_bbox")},
                      l2(g, got_g)))
    for k in ("loss", "loss_cls", "loss_bbox"):
        bar = 3 * max(mv[0][k] for mv in moves) if k != "loss" else (
            3 * max(mv[0]["loss_cls"] + mv[0]["loss_bbox"] for mv in moves))
        assert abs(float(got_m[k]) - float(want_m[k])) <= bar + 1e-5 * abs(float(want_m[k])), k
    assert all(np.isfinite(g).all() for g in got_g.values())
    assert l2(got_g, want_g) <= 3 * max(mv[1] for mv in moves)
    assert max(mv[1] for mv in moves) > 1e-3  # the chaos the bar is made of is there


def test_qdq_loss_differs_from_the_float_loss(case, qat_case):  # noqa: F811
    """With scales the QDQ sites fake-quantize: the QAT loss is not the
    floating-point loss, in the port as in the JAX package."""
    cfg, jmodel, variables, quant, single = qat_case
    fp = BEVFormer(case[0])
    fp.load_state_dict(params_from_jax(variables), strict=True)
    q = _port_qat_model(cfg, variables, quant)
    with torch.no_grad():
        fp_loss = float(loss_fn(fp, _tensors(single))[0])
        q_loss = float(loss_fn(q, _tensors(single))[0])
    assert np.isfinite(q_loss) and abs(q_loss - fp_loss) > 1e-7
    jfp = _jax_step(make_train_step, case[2], variables, single)[0]["loss"]
    jq = _jax_step(make_train_step, jmodel, variables, single, quant_vars=quant)[0]["loss"]
    assert abs(float(jq) - float(jfp)) > 1e-7
    assert rel(fp_loss, float(jfp)) < 1e-5 and rel(q_loss, float(jq)) < 1e-5


def test_missing_live_scale_raises(qat_case):
    """A quantized model with a live site that has no scale would train
    floating point there: the step raises.  A site the policy switched off
    needs none."""
    cfg, _, variables, quant, single = qat_case
    model = BEVFormer(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    opt = Optimizer(model, learning_rate=1e-6)
    with pytest.raises(ValueError, match="no scale"):
        train_step(model, opt, _tensors(single))
    scales = {n: float(v) for n, v in _flat_scales(quant).items()}
    first = sorted(scales)[0]
    partial = {n: v for n, v in scales.items() if n != first}
    attach_quant_scales(model, partial)
    with pytest.raises(ValueError, match=first):
        check_quant_scales(model)
    excluded = BEVFormer(bevformer_micro(quant=True, quant_exclude=(first,), **OVER))
    excluded.load_state_dict(params_from_jax(variables), strict=True)
    attach_quant_scales(excluded, partial)
    check_quant_scales(excluded)
    assert all(m.wq is None for m in excluded.modules() if isinstance(m, (QConv, QDense)))
    metrics = train_step(excluded, Optimizer(excluded, learning_rate=1e-6), _tensors(single))
    assert np.isfinite(float(metrics["loss"]))
    # a floating-point model needs no scales
    check_quant_scales(BEVFormer(bevformer_micro(**OVER)))


def _flat_scales(quant, prefix=()):
    out = {}
    for k, v in quant.items():
        if isinstance(v, dict):
            out.update(_flat_scales(v, prefix + (k,)))
        else:
            out["/".join(prefix)] = v
    return out


def test_upstream_layout_takes_a_qat_model(qat_case):
    """The QDQ scale buffers are no upstream keys: a QAT model's state_dict
    writes the floating-point model's upstream checkpoint."""
    cfg, _, variables, quant, _ = qat_case
    model = _port_qat_model(cfg, variables, quant)
    sd = model.state_dict()
    assert any(k.endswith(".scale") for k in sd)
    up = upstream_layout(cfg, sd)
    fp_cfg = bevformer_micro(**OVER)
    fp = init_weights(BEVFormer(fp_cfg), torch.Generator().manual_seed(0))
    assert sorted(up) == sorted(upstream_layout(fp_cfg, fp.state_dict()))
    back = load_bevformer_checkpoint(fp_cfg, up)
    assert all(torch.equal(back[k], sd[k]) for k in back)


@pytest.fixture(scope="module")
def qat_run(tmp_path_factory):
    """A micro set; 2 floating-point steps; `max` scales of that checkpoint
    with one site pattern excluded; 2 QAT steps from it."""
    tmp = tmp_path_factory.mktemp("qat")
    root = make_synthetic_set(tmp / "set")
    common = ["--infos", str(root / SYNTH_INFOS), "--data-root", str(root), "--device", "cpu"]
    fp = train.main(["micro", *common, "--steps", "2", "--out", str(tmp / "fp.pth")])
    scales = str(tmp / "scales.npz")
    calibrate.main(["micro", *common, "--checkpoint", str(tmp / "fp.pth"), "--length", "2",
                    "--method", "max", "--exclude", "decoder/layer0/ffn", "--out", scales])
    qat = train.main(["micro", *common, "--steps", "2", "--quant-scales", scales, "--lr", "1e-3",
                      "--checkpoint", str(tmp / "fp.pth"), "--out", str(tmp / "qat.pth")])
    return tmp, root, common, fp, scales, qat


def test_train_cli_quant_scales(qat_run):
    """`--quant-scales`: the QDQ tier under the scales' policy, every live
    site holding its scale, no fold, the lr of the QAT recipe unless given."""
    tmp, root, common, fp, scales, qat = qat_run
    assert qat.cfg.quant is True and qat.cfg.quant_exclude == load_policy(scales) == (
        "decoder/layer0/ffn",)
    sites = qdq_sites(qat.model)
    assert sites and all(s.scale is not None for s in sites.values())
    assert not any("decoder/layer0/ffn" in n for n in sites)
    assert all(m.wq is None for m in qat.model.modules() if isinstance(m, (QConv, QDense)))
    assert qat.optimizer.peak == 1e-3 and all(np.isfinite(m["loss"]) for m in qat.metrics)
    default = train.main(["micro", *common, "--steps", "1", "--quant-scales", scales,
                          "--out", str(tmp / "default.pth")])
    assert default.optimizer.peak == 1e-6
    moved = [n for n, p in qat.model.named_parameters()
             if not torch.equal(p.detach().cpu(), fp.model.state_dict()[n].cpu())]
    assert moved


def test_qat_checkpoint_evaluates_under_int8_with_folds_of_the_qat_weights(qat_run):
    """tools/evaluate.py --quant int8 reads the QAT `.pth` and folds every
    int8 layer's weights from it; some folds differ from those of the
    weights the scales were calibrated on."""
    tmp, root, common, fp, scales, qat = qat_run
    res = evaluate.main(["micro", "--infos", str(root / SYNTH_INFOS), "--data-root", str(root),
                         "--device", "cpu", "--checkpoint", str(tmp / "qat.pth"),
                         "--quant-scales", scales, "--quant", "int8"])
    assert all(np.isfinite(v) for v in res.metrics.values())
    qat_sd = load_torch_checkpoint(str(tmp / "qat.pth"))
    trained = load_bevformer_checkpoint(res.engine.cfg, qat_sd)
    before = {k: v.cpu() for k, v in fp.model.state_dict().items()}
    folded = moved = 0
    for name, m in res.engine.model.named_modules():
        if isinstance(m, (QConv, QDense)) and m.mode == "int8":
            wq, wscale = quantize_weight(trained[f"{name}.weight"])
            assert torch.equal(m.wq, wq) and torch.equal(m.wscale, wscale), name
            old = quantize_weight(before[f"{name}.weight"])
            moved += not (torch.equal(old[0], wq) and torch.equal(old[1], wscale))
            folded += 1
    assert folded > 50 and moved > 0
    assert CalibrationResult.load(scales).method == "max"


def test_chip_smoke_replay_check_sees_a_wrong_msda(qat_case, monkeypatch):
    """`chip_smoke.py`'s QAT check, run here on the plain path: with every
    QDQ site's rounding replayed from a recorded run, an MSDA output off by
    a relative 1e-4 leaves the loss exactly as it was (a loss and gradient
    check alone cannot see it) but moves the inputs of the MSDA-fed sites by
    1e-4 of their largest value, above the check's bar; unchanged, every
    site's input and the loss are equal."""
    import importlib.util
    from pathlib import Path

    from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
    from bevformer_tensorrt_tpu_torch.quant.qdq import QDQ

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, _, variables, quant, single = qat_case
    model = _port_qat_model(cfg, variables, quant)
    batch = _tensors(single)
    names = {id(m): n for n, m in model.named_modules() if isinstance(m, QDQ)}
    plain = msda_ops.multi_scale_deformable_attn
    for eps in (0.0, 1e-4):
        kept, drift = {}, {}
        with smoke.rounding("record", kept):
            loss = smoke.step_grads(model, batch)[0]
        monkeypatch.setattr(msda_ops, "multi_scale_deformable_attn",
                            lambda *a, **k: plain(*a, **k) * (1 + eps))
        with smoke.rounding("replay", kept, drift):
            replayed = smoke.step_grads(model, batch)[0]
        monkeypatch.setattr(msda_ops, "multi_scale_deformable_attn", plain)
        drift = {names[i]: e for i, e in drift.items()}
        fed = [e for n, e in drift.items() if n.endswith(".output_proj.qdq_in")]
        assert replayed == loss and len(fed) == 3 and len(drift) == len(kept), eps
        if eps == 0.0:
            assert max(drift.values()) == 0.0
        else:
            assert min(fed) > smoke.QAT_SITE_REL and max(fed) == pytest.approx(eps, rel=0.05)
