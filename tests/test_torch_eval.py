"""The port's loader-driven entry points against the JAX package (CPU, micro).

One generated nuScenes-layout set (4 frames in 2 scenes, 2 cameras of
96x160, the cameras' focal length cut to 80 px) and one set of seeded flax
variables.  The port reads the weights
from an upstream-layout `.pth` (the variables through `params_from_jax` and
`upstream_layout`), as a user's checkpoint would come.

  * `tools/evaluate.py` on the CPU against the JAX engine over the JAX
    loader's frames: raw classes and coords of every frame within 1e-4
    relative (the bar of the two-frame end-to-end test); the port's
    evaluator fed the JAX detections gives JAX's metrics exactly.
  * The pipelined loop gives the serial loop's detections bit for bit.
  * The loader-driven calibration against the JAX CLI's procedure run here:
    a float32 pre-pass through the JAX engine records each frame's inputs,
    then JAX's `collect_stats` and `scales_from_stats` on the QDQ model.
    `max` within 1e-5 relative, `percentile` and `entropy` within one
    histogram bin (as tests/test_torch_quant_model.py holds them).  The
    JAX side excludes the pseudo-sites it reaches only on a TPU, which hold
    no scales; the port's CLI is given those and one real site, and as in
    the JAX CLI the exclusions reach only the policy: every site is
    calibrated.
  * One `--quant int8` evaluation from those scales.

The generator's rig (focal 1200 px) on 160-pixel-wide views would give a
field of view of 7.6 degrees, in which no query of micro's 8x8 BEV grid
projects; at 80 px the views are 90 degrees wide and every camera sees 12
to 20 queries, so the outputs depend on the pixels the loader passes (the
fixture checks both: every camera sees the grid, and changing the pixels
changes the outputs).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from bevformer_tensorrt_tpu.core.nms_free_coder import NMSFreeCoder as JaxCoder
from bevformer_tensorrt_tpu.data.nuscenes import IMG_NORM_CAFFE as JAX_CAFFE
from bevformer_tensorrt_tpu.data.nuscenes import NuScenesFrames as JaxFrames
from bevformer_tensorrt_tpu.evalsuite import detections_to_eval_boxes as jax_det_boxes
from bevformer_tensorrt_tpu.evalsuite import evaluate_nuscenes as jax_evaluate
from bevformer_tensorrt_tpu.evalsuite import gt_to_eval_boxes as jax_gt_boxes
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.quant.calibrate import collect_stats as jax_collect_stats
from bevformer_tensorrt_tpu.quant.calibrate import scales_from_stats as jax_scales_from_stats
from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine
from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.evalsuite import (
    detections_to_eval_boxes,
    evaluate_nuscenes,
    gt_to_eval_boxes,
)
from bevformer_tensorrt_tpu_torch.models.modules.encoder import cam_budget_overflow
from bevformer_tensorrt_tpu_torch.quant.qdq import QDQ
from bevformer_tensorrt_tpu_torch.quant.fold import attach_quant_scales
from bevformer_tensorrt_tpu_torch.quant.observers import NUM_BINS, CalibrationResult
from bevformer_tensorrt_tpu_torch.quant.policy import load_policy, quant_excluded
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.torch_import import upstream_layout
from bevformer_tensorrt_tpu_torch.tools import calibrate, evaluate
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from bevformer_tensorrt_tpu_torch.tools.path_diff import run_frames
from torch_port_helpers import SYNTH_INFOS as INFOS
from torch_port_helpers import make_synthetic_set, random_variables, rel

torch.set_num_threads(2)

OFF_TPU = ("msda_tables", "flash")  # sites the JAX package reaches only on a TPU
EXCLUDE = OFF_TPU + ("cls_branch1",)  # the policy given to the port's calibration CLI
FOCAL = 80.0  # px: micro's BEV grid projects into the 160x96 views


def shorten_focal(root):
    """Rewrite the generated infos' camera intrinsics to FOCAL."""
    with open(root / INFOS, "rb") as fh:
        data = pickle.load(fh)
    for info in data["infos"]:
        for cam in info["cams"].values():
            k = np.asarray(cam["cam_intrinsic"], np.float64).copy()
            k[0, 0] = k[1, 1] = FOCAL
            cam["cam_intrinsic"] = k
    with open(root / INFOS, "wb") as fh:
        pickle.dump(data, fh)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(set root, .pth path, flax variables, JAX engine, JAX loader)."""
    tmp = tmp_path_factory.mktemp("eval")
    root = make_synthetic_set(tmp / "set")
    shorten_focal(root)
    jcfg = jax_configs.bevformer_micro(msda_impl="jnp")
    frames = JaxFrames(root / INFOS, root, img_norm=JAX_CAFFE, target_hw=(jcfg.img_h, jcfg.img_w))
    for i in range(len(frames)):  # every camera sees the grid, within the compaction budget
        visible, overflow = cam_budget_overflow(bevformer_micro(), frames.frame(i).lidar2img)
        assert visible.min() > 0 and overflow == 0, (i, visible, overflow)
    f0 = frames.frame(0)
    nq = jcfg.bev_h * jcfg.bev_w
    model = JaxBEVFormer(jcfg)
    variables = random_variables(model, np.random.default_rng(7), f0.image,
                                 np.zeros((nq, 1, jcfg.embed_dims), np.float32), np.float32(0.0),
                                 f0.can_bus, f0.lidar2img)
    ckpt = tmp / "micro.pth"
    torch.save(upstream_layout(bevformer_micro(), params_from_jax(variables)), ckpt)
    engine = JaxEngine(model, variables, jcfg, donate_prev_bev=False)
    return root, str(ckpt), variables, engine, frames


def set_args(root):
    return ["--infos", str(root / INFOS), "--data-root", str(root), "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_eval(case):
    """The JAX package's evaluation loop, serial: raw outputs, detections, metrics."""
    _, _, _, engine, frames = case
    coder = JaxCoder(num_classes=10)
    engine.reset()
    outs, dets, gt, pred = [], [], [], []
    for i in range(len(frames)):
        f = frames.frame(i)
        classes, coords = (np.asarray(t) for t in engine.infer_frame(
            f.image, f.can_bus, f.lidar2img, f.scene_token))
        det = coder.decode(classes, coords)[0]
        outs.append((classes, coords))
        dets.append(det)
        pred += jax_det_boxes(f.sample_token, det)
        gt += jax_gt_boxes(f.sample_token, f.gt_boxes, f.gt_labels)
    return outs, dets, jax_evaluate(gt, pred)


@pytest.fixture(scope="module")
def port_eval(case):
    root, ckpt = case[:2]
    return evaluate.main(["micro", "--checkpoint", ckpt] + set_args(root))


def test_evaluate_matches_jax(port_eval, jax_eval):
    outs, dets, jax_metrics = jax_eval
    assert port_eval.indices == [0, 1, 2, 3]
    assert [f.scene_token for f in map(port_eval.frames.frame, port_eval.indices)] == \
        ["scene0", "scene0", "scene1", "scene1"]
    # the raw outputs of the evaluator's engine over its frames, from a fresh state
    frames = [dict(image=f.image, can_bus=f.can_bus, lidar2img=f.lidar2img,
                   scene_token=f.scene_token) for f in map(port_eval.frames.frame, port_eval.indices)]
    raw = [(classes, coords) for _, classes, coords in run_frames(port_eval.engine, frames)]
    assert len(raw) == len(outs) == 4
    # the pixels reach the outputs: the same frames with the views mirrored differ
    mirrored = [dict(f, image=np.ascontiguousarray(f["image"][..., ::-1])) for f in frames]
    for (_, classes, coords), (want_classes, want_coords) in zip(
            run_frames(port_eval.engine, mirrored), raw):
        assert rel(classes.numpy(), want_classes.numpy()) > 1e-3
        assert rel(coords.numpy(), want_coords.numpy()) > 1e-3
    for i, ((classes, coords), (jclasses, jcoords)) in enumerate(zip(raw, outs)):
        assert tuple(classes.shape) == jclasses.shape == (2, 1, 16, 10)
        assert rel(classes.numpy(), jclasses) < 1e-4, i
        assert rel(coords.numpy(), jcoords) < 1e-4, i
    assert all(np.isfinite(v) for v in port_eval.metrics.values())
    assert port_eval.metrics["fps"] > 0 and len(port_eval.run.latencies) == 4
    # the port's conversion and evaluator on the JAX detections: JAX's metrics exactly
    gt, pred = [], []
    for det, f in zip(dets, map(port_eval.frames.frame, port_eval.indices)):
        pred += detections_to_eval_boxes(f.sample_token, det)
        gt += gt_to_eval_boxes(f.sample_token, f.gt_boxes, f.gt_labels)
    assert len(pred) == sum(len(d["scores_3d"]) for d in dets) > 0
    assert evaluate_nuscenes(gt, pred) == jax_metrics


def test_pipelined_loop_equals_serial(port_eval):
    serial = evaluate.eval_loop(port_eval.engine, port_eval.frames, port_eval.indices,
                                pipelined=False)
    assert len(serial.detections) == len(port_eval.run.detections) == 4
    for got, want in zip(port_eval.run.detections, serial.detections):
        assert sorted(got) == ["boxes_3d", "labels_3d", "scores_3d"]
        for k in got:
            assert np.array_equal(got[k], want[k]), k
    assert len(serial.pred_boxes) == len(port_eval.run.pred_boxes)


def jax_loader_calibration(case):
    """The JAX CLI's procedure (tools/bevformer/calibrate.py) in process:
    the float32 pre-pass, then the stats passes on the QDQ model."""
    _, _, variables, engine, frames = case
    nq = 64
    engine.reset()
    batches = []
    for i in range(len(frames)):
        f = frames.frame(i)
        delta, use_prev = engine.state.step_can_bus(f.can_bus, f.scene_token)
        prev = (engine.state.prev_bev if engine.state.prev_bev is not None
                else jnp.zeros((nq, 1, 64), jnp.float32))
        batches.append((f.image, np.asarray(prev), np.float32(use_prev), delta, f.lidar2img))
        engine.state.prev_bev = engine._apply(engine.variables, f.image, prev,
                                              jnp.float32(use_prev), jnp.asarray(delta),
                                              f.lidar2img)[0]
    model_q = JaxBEVFormer(jax_configs.bevformer_micro(msda_impl="jnp", quant=True,
                                                       quant_exclude=OFF_TPU))
    fns = {}

    def apply_fn(v, batch, mutable):
        key = tuple(mutable)
        if key not in fns:
            fns[key] = jax.jit(lambda v, *a: model_q.apply(v, *a, mutable=list(key))[1])
        return fns[key](v, *batch)

    return jax_collect_stats(apply_fn, variables, batches)


@pytest.fixture(scope="module")
def loader_scales(case, tmp_path_factory):
    root, ckpt = case[:2]
    out = str(tmp_path_factory.mktemp("scales") / "micro.npz")
    calibrate.main(["micro", "--checkpoint", ckpt, "--length", "4", "--method", "max",
                    "--also-methods", "percentile,entropy", "--exclude", *EXCLUDE,
                    "--save-stats", out + ".stats.npz", "--out", out] + set_args(root))
    return out


def test_loader_calibration_matches_jax_cli(case, loader_scales):
    amax_stats, hist_stats = jax_loader_calibration(case)
    results = {m: CalibrationResult.load(loader_scales if m == "max" else f"{loader_scales}.{m}")
               for m in ("max", "percentile", "entropy")}
    stats = np.load(loader_scales + ".stats.npz")
    for method, result in results.items():
        assert result.method == method
        assert load_policy(loader_scales if method == "max" else f"{loader_scales}.{method}") \
            == EXCLUDE
        want = jax_scales_from_stats(amax_stats, hist_stats, method=method)[1].scales
        assert sorted(result.scales) == sorted(want) and len(want) == 132
        # the excluded real site is calibrated all the same
        assert len([n for n in want if quant_excluded(n.split("/"), EXCLUDE)]) == 3
        for name, scale in want.items():
            got = result.scales[name]
            if method == "max":
                assert got == pytest.approx(scale, rel=1e-5), name
            else:
                one_bin = float(stats[f"amax/{name}"]) / NUM_BINS / 127.0
                assert abs(got - scale) <= one_bin * 1.001 + 1e-5 * scale, (method, name)
    # an int8 engine with no site excluded finds a scale at every site
    engine = BEVFormerEngine(bevformer_micro(quant="int8", quant_exclude=()), device="cpu", seed=0)
    attach_quant_scales(engine.model, results["max"].scales)
    assert not [n for n, m in engine.model.named_modules()
                if isinstance(m, QDQ) and m.mode != "off" and m.scale is None]


def test_int8_evaluate_from_loader_scales(case, loader_scales):
    root = case[0]
    ops.reset_launch_counts()
    res = evaluate.main(["micro", "--checkpoint", case[1], "--quant-scales", loader_scales,
                         "--quant", "int8"] + set_args(root))
    assert res.engine.cfg.quant == "int8" and res.engine.cfg.quant_exclude == EXCLUDE
    assert res.engine.model.img_backbone.stem_conv.wq.dtype == torch.int8
    assert all(np.isfinite(v) for v in res.metrics.values())
    assert sum(len(d["scores_3d"]) for d in res.run.detections) > 0
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 12  # CPU: plain versions


def test_bfloat16_evaluation_keeps_one_dtype_per_kernel_call(case, monkeypatch):
    """At the evaluator's default --cam-budget 1.0 the camera attention takes
    its branch without compaction.  The card's MSDA kernel takes its
    offsets and logits in the value's dtype, so in bfloat16 every MSDA call
    of the frame must see one dtype (the CPU's plain version accepts any)."""
    from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops

    wrapper, seen = msda_ops.multi_scale_deformable_attn, []

    def checked(value, ref, off, attn, shapes):
        seen.append((value.dtype, off.dtype, attn.dtype, ref.dtype))
        return wrapper(value, ref, off, attn, shapes)

    monkeypatch.setattr(msda_ops, "multi_scale_deformable_attn", checked)
    res = evaluate.main(["micro", "--checkpoint", case[1], "--dtype", "bfloat16",
                         "--limit", "2"] + set_args(case[0]))
    assert res.engine.cfg.cam_budget == 1.0 and len(seen) == 2 * 6
    assert set(seen) == {(torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)}
    assert all(np.isfinite(v) for v in res.metrics.values())
