"""A second witness for the accuracy cycle's int8 drops, on the CPU.

    python tests/test_torch_accuracy_witness.py <workdir of tools/accuracy_cycle.py> \\
        [--model micro] [--dtype bfloat16] [--ways port,port_float_tables,jax] [--out w.json]

reads the cycle's generated set (`synth/`), its floating-point checkpoint
(`fp.pth`), its scales (`scales.npz`, the policy beside it) and its QAT
checkpoint (`qat.pth`), and evaluates the three stages (fp, int8 PTQ, int8
QAT) in `--dtype`, as the cycle does, three ways:

  * `port`: the port's `tools/evaluate.py --device cpu` under the scales'
    policy, the configuration the card ran, on the plain versions of its
    kernels;
  * `port_float_tables`: the same with the MSDA value tables and flash
    attention also kept in floating point (`msda_tables`, `flash`);
  * `jax`: the JAX package's evaluation (its engine, NMS-free coder and
    evaluator, as `tools/bevformer/evaluate.py` runs them) of the same files
    on the CPU, where the JAX package has no MSDA-table or flash sites (their
    int8 forms are Pallas kernels of the TPU), so it computes the second.

If `port` gives the card's drops, the kernels are not what costs them; if
`port_float_tables` equals `jax`, the port's int8 layers compute the JAX
package's; the difference between `port` and `port_float_tables` is what
the int8 value tables and int8 flash cost.  The test runs the witness on a
set of 4 frames with 1 training and 1 QAT step, the cameras' focal length
cut so that the BEV grid sees the images.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

OFF_TPU = ("msda_tables", "flash")  # sites the JAX package has only on a TPU
STAGES = (("fp", "fp.pth", False), ("int8_ptq", "fp.pth", True),
          ("int8_qat", "qat.pth", True))
INFOS = "nuscenes_infos_synthetic.pkl"
# max |score - JAX's| of the test's detections: floating point as the raw
# outputs are held (1e-4 relative; 4.1e-8 measured); int8 at 1e-2, where
# the two packages' roundings part on a few values (1.2e-3 and 1.4e-3
# measured; the int8 model tests hold raw outputs at rms 5e-2)
SCORE_TOL = {"fp": 1e-4, "int8_ptq": 1e-2, "int8_qat": 1e-2}


def port_runs(workdir: Path, model: str, dtype: str, exclude_more=()) -> dict:
    """The port's evaluator on the CPU: each stage's (metrics, the scores of
    its detections, frame after frame)."""
    from bevformer_tensorrt_tpu_torch.quant.policy import load_policy
    from bevformer_tensorrt_tpu_torch.tools import evaluate

    synth, scales = workdir / "synth", str(workdir / "scales.npz")
    exclude = load_policy(scales) + tuple(exclude_more)
    out = {}
    for stage, ckpt, int8 in STAGES:
        argv = [model, "--infos", str(synth / INFOS), "--data-root", str(synth), "--dtype",
                dtype, "--checkpoint", str(workdir / ckpt), "--device", "cpu"]
        if int8:
            argv += ["--quant-scales", scales, "--quant", "int8"]
            for p in exclude or ("",):
                argv += ["--quant-exclude", p]
        res = evaluate.main(argv)
        out[stage] = (res.metrics, np.concatenate([np.asarray(d["scores_3d"])
                                                   for d in res.run.detections]))
    return out


def jax_runs(workdir: Path, model: str, dtype: str) -> dict:
    """The JAX package's evaluation of the same files: each stage's
    (metrics, detection scores)."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bevformer_tensorrt_tpu.configs import bevformer as cfgs
    from bevformer_tensorrt_tpu.core.nms_free_coder import NMSFreeCoder
    from bevformer_tensorrt_tpu.data.nuscenes import IMG_NORM_CAFFE, IMG_NORM_PYTORCH
    from bevformer_tensorrt_tpu.data.nuscenes import NuScenesFrames
    from bevformer_tensorrt_tpu.evalsuite import (
        detections_to_eval_boxes,
        evaluate_nuscenes,
        gt_to_eval_boxes,
    )
    from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer
    from bevformer_tensorrt_tpu.quant.fold import attach_quant_scales
    from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu.runtime.torch_import import load_variables
    from bevformer_tensorrt_tpu_torch.quant.observers import CalibrationResult
    from bevformer_tensorrt_tpu_torch.quant.policy import load_policy

    synth, scales = workdir / "synth", str(workdir / "scales.npz")
    quant_tree = traverse_util.unflatten_dict(
        {tuple(name.split("/")) + ("scale",): np.float32(v)
         for name, v in CalibrationResult.load(scales).scales.items()})
    out = {}
    for stage, ckpt, int8 in STAGES:
        cfg = getattr(cfgs, f"bevformer_{model}")(
            dtype=dtype, quant="int8" if int8 else False, cam_budget=1.0,
            quant_exclude=load_policy(scales) if int8 else ())
        net = BEVFormer(cfg)
        frames = NuScenesFrames(synth / INFOS, synth,
                                img_norm=IMG_NORM_PYTORCH if model == "tiny" else IMG_NORM_CAFFE,
                                target_hw=(cfg.img_h, cfg.img_w))
        nq = cfg.bev_h * cfg.bev_w
        dummy = (jnp.zeros((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), jnp.float32),
                 jnp.zeros((nq, 1, cfg.embed_dims), jnp.float32), jnp.float32(0.0),
                 jnp.zeros(cfg.can_bus_dims, jnp.float32),
                 jnp.zeros((1, cfg.num_cams, 4, 4), jnp.float32))
        variables = jax.jit(net.init)(jax.random.PRNGKey(0), *dummy)
        variables = load_variables(str(workdir / ckpt), variables, family="bevformer", cfg=cfg)
        if int8:
            variables = attach_quant_scales(variables, quant_tree)
        engine = BEVFormerEngine(net, variables, cfg)
        coder = NMSFreeCoder(num_classes=cfg.num_classes)
        gt, pred, scores = [], [], []
        for i in range(len(frames)):
            f = frames.frame(i)
            classes, coords = engine.infer_frame(f.image, f.can_bus, f.lidar2img, f.scene_token)
            det = coder.decode(np.asarray(classes), np.asarray(coords))[0]
            pred += detections_to_eval_boxes(f.sample_token, det)
            gt += gt_to_eval_boxes(f.sample_token, f.gt_boxes, f.gt_labels)
            scores.append(np.asarray(det["scores_3d"]))
        out[stage] = (evaluate_nuscenes(gt, pred), np.concatenate(scores))
    return out


WAYS = {"port": lambda wd, model, dtype: port_runs(wd, model, dtype),
        "port_float_tables": lambda wd, model, dtype: port_runs(wd, model, dtype, OFF_TPU),
        "jax": jax_runs}


def runs(workdir, model: str = "micro", dtype: str = "bfloat16", ways=tuple(WAYS)) -> dict:
    """Each stage's (metrics, detection scores) for each of `ways`."""
    return {way: WAYS[way](Path(workdir), model, dtype) for way in ways}


def record(workdir, model: str, dtype: str, evaluated: dict) -> dict:
    """NDS and drops of the three stages, each way."""
    rec = {"workdir": str(workdir), "model": model, "dtype": dtype}
    for name, stages in evaluated.items():
        nds = {stage: round(float(m["NDS"]), 4) for stage, (m, _) in stages.items()}
        rec[name] = dict(nds, nds_drop_ptq=round(nds["fp"] - nds["int8_ptq"], 4),
                         nds_drop_qat=round(nds["fp"] - nds["int8_qat"], 4))
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", help="a `tools/accuracy_cycle.py --workdir`")
    ap.add_argument("--model", default="micro", choices=("micro", "tiny", "small"))
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--ways", default=",".join(WAYS),
                    help="comma-separated subset of " + ", ".join(WAYS) + " (a machine "
                         "without JAX runs the port's two)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ways = tuple(args.ways.split(","))
    rec = record(args.workdir, args.model, args.dtype,
                 runs(args.workdir, args.model, args.dtype, ways))
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


def test_witness_on_a_small_cycle(tmp_path):
    """The three stages' files made as the cycle makes them (1 training
    step, `max` scales, 1 QAT step), the cameras seeing the BEV grid, in
    float32: the port with its tables and flash in floating point gives the
    JAX package's detections, every score within SCORE_TOL of JAX's."""
    import torch

    from bevformer_tensorrt_tpu_torch.tools import calibrate, train
    from test_torch_eval import shorten_focal
    from torch_port_helpers import make_synthetic_set

    torch.set_num_threads(2)
    synth = make_synthetic_set(tmp_path / "synth")
    shorten_focal(synth)
    common = ["--infos", str(synth / INFOS), "--data-root", str(synth), "--device", "cpu"]
    train.main(["micro", *common, "--steps", "1", "--no-augment", "--out",
                str(tmp_path / "fp.pth")])
    calibrate.main(["micro", *common, "--checkpoint", str(tmp_path / "fp.pth"), "--length", "4",
                    "--method", "max", "--out", str(tmp_path / "scales.npz")])
    train.main(["micro", *common, "--steps", "1", "--no-augment", "--lr", "1e-5",
                "--checkpoint", str(tmp_path / "fp.pth"), "--quant-scales",
                str(tmp_path / "scales.npz"), "--out", str(tmp_path / "qat.pth")])
    evaluated = runs(tmp_path, "micro", "float32")
    rec = record(tmp_path, "micro", "float32", evaluated)
    for name in ("port", "port_float_tables", "jax"):
        assert sorted(rec[name]) == ["fp", "int8_ptq", "int8_qat", "nds_drop_ptq",
                                     "nds_drop_qat"], name
    for stage in ("fp", "int8_ptq", "int8_qat"):
        got, want = evaluated["port_float_tables"][stage][1], evaluated["jax"][stage][1]
        assert got.shape == want.shape and len(want) > 0, stage
        assert np.abs(got - want).max() <= SCORE_TOL[stage], stage
    assert np.array_equal(evaluated["port"]["fp"][1], evaluated["port_float_tables"]["fp"][1])


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
