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
import pytest

from bevformer_tensorrt_tpu_torch.tools.quant_ablation import POLICIES

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


def jax_prepare(workdir: Path, model: str, dtype: str, stage: str, engines: dict):
    """(cfg, engine, variables) of one stage in the JAX package: its
    checkpoint loaded and, under int8, the scales attached and the weights
    folded.  `engines` keeps one engine per configuration across calls, so
    its compiled forward serves the next checkpoint too."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bevformer_tensorrt_tpu.configs import bevformer as cfgs
    from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer
    from bevformer_tensorrt_tpu.quant.fold import attach_quant_scales
    from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu.runtime.torch_import import load_variables
    from bevformer_tensorrt_tpu_torch.quant.observers import CalibrationResult
    from bevformer_tensorrt_tpu_torch.quant.policy import load_policy

    ckpt, int8 = {s: (c, q) for s, c, q in STAGES}[stage]
    scales = str(workdir / "scales.npz")
    cfg = getattr(cfgs, f"bevformer_{model}")(
        dtype=dtype, quant="int8" if int8 else False, cam_budget=1.0,
        quant_exclude=load_policy(scales) if int8 else ())
    if int8 not in engines:
        net = BEVFormer(cfg)
        nq = cfg.bev_h * cfg.bev_w
        dummy = (jnp.zeros((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), jnp.float32),
                 jnp.zeros((nq, 1, cfg.embed_dims), jnp.float32), jnp.float32(0.0),
                 jnp.zeros(cfg.can_bus_dims, jnp.float32),
                 jnp.zeros((1, cfg.num_cams, 4, 4), jnp.float32))
        # the template's leaves are NaN (its shapes from `jax.eval_shape`,
        # nothing compiled): a leaf the checkpoint does not fill would turn
        # the scores NaN
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *dummy)
        init = jax.tree.map(lambda x: jnp.full(x.shape, jnp.nan, x.dtype), shapes)
        engines[int8] = (init, BEVFormerEngine(net, init, cfg))
    init, engine = engines[int8]
    variables = load_variables(str(workdir / ckpt), init, family="bevformer", cfg=cfg)
    if int8:
        quant_tree = traverse_util.unflatten_dict(
            {tuple(name.split("/")) + ("scale",): np.float32(v)
             for name, v in CalibrationResult.load(scales).scales.items()})
        variables = attach_quant_scales(variables, quant_tree)
    return cfg, engine, variables


def jax_evaluate(workdir: Path, model: str, cfg, engine, variables):
    """(metrics, detection scores) of the JAX engine with `variables` over
    the cycle's set, as `tools/bevformer/evaluate.py` runs it."""
    import jax

    from bevformer_tensorrt_tpu.core.nms_free_coder import NMSFreeCoder
    from bevformer_tensorrt_tpu.data.nuscenes import IMG_NORM_CAFFE, IMG_NORM_PYTORCH
    from bevformer_tensorrt_tpu.data.nuscenes import NuScenesFrames
    from bevformer_tensorrt_tpu.evalsuite import (
        detections_to_eval_boxes,
        evaluate_nuscenes,
        gt_to_eval_boxes,
    )

    synth = workdir / "synth"
    engine.variables = jax.device_put(variables)
    engine.reset()
    frames = NuScenesFrames(synth / INFOS, synth,
                            img_norm=IMG_NORM_PYTORCH if model == "tiny" else IMG_NORM_CAFFE,
                            target_hw=(cfg.img_h, cfg.img_w))
    coder = NMSFreeCoder(num_classes=cfg.num_classes)
    gt, pred, scores = [], [], []
    for i in range(len(frames)):
        f = frames.frame(i)
        classes, coords = engine.infer_frame(f.image, f.can_bus, f.lidar2img, f.scene_token)
        det = coder.decode(np.asarray(classes), np.asarray(coords))[0]
        pred += detections_to_eval_boxes(f.sample_token, det)
        gt += gt_to_eval_boxes(f.sample_token, f.gt_boxes, f.gt_labels)
        scores.append(np.asarray(det["scores_3d"]))
    return evaluate_nuscenes(gt, pred), np.concatenate(scores)


def jax_runs(workdir: Path, model: str, dtype: str) -> dict:
    """The JAX package's evaluation of the same files: each stage's
    (metrics, detection scores)."""
    engines = {}
    return {stage: jax_evaluate(workdir, model, *jax_prepare(workdir, model, dtype, stage,
                                                             engines))
            for stage, _, _ in STAGES}


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


# The test runs the witness on the files of a small cycle (1 training step,
# `max` scales, 1 QAT step; the cameras see the BEV grid), in float32: the
# port with its tables and flash in floating point gives the JAX package's
# detections, every score within SCORE_TOL of JAX's.  The cycle's files and
# each way's evaluations are module fixtures, each check a test of its own.

@pytest.fixture(scope="module")
def cycle_dir(tmp_path_factory):
    """A cycle's workdir as `tools/accuracy_cycle.py` leaves it: synth/,
    fp.pth, scales.npz (its policy beside it) and qat.pth."""
    import torch

    from bevformer_tensorrt_tpu_torch.tools import calibrate, train
    from test_torch_eval import shorten_focal
    from torch_port_helpers import make_synthetic_set

    torch.set_num_threads(2)
    wd = tmp_path_factory.mktemp("cycle")
    synth = make_synthetic_set(wd / "synth")
    shorten_focal(synth)
    common = ["--infos", str(synth / INFOS), "--data-root", str(synth), "--device", "cpu"]
    train.main(["micro", *common, "--steps", "1", "--no-augment", "--out", str(wd / "fp.pth")])
    calibrate.main(["micro", *common, "--checkpoint", str(wd / "fp.pth"), "--length", "4",
                    "--method", "max", "--out", str(wd / "scales.npz")])
    train.main(["micro", *common, "--steps", "1", "--no-augment", "--lr", "1e-5",
                "--checkpoint", str(wd / "fp.pth"), "--quant-scales", str(wd / "scales.npz"),
                "--out", str(wd / "qat.pth")])
    return wd


@pytest.fixture(scope="module")
def evaluated(cycle_dir):
    """Each way's stages, filled by the tests that need them."""
    return {}


def way(evaluated, cycle_dir, name):
    """`evaluated[name]` for the port's ways (float32, micro), computed once."""
    if name not in evaluated:
        evaluated[name] = WAYS[name](cycle_dir, "micro", "float32")
    return evaluated[name]


def jax_stage(evaluated, cycle_dir, stage, evaluate=True):
    """The JAX package's (cfg, engine, variables) of `stage` and, with
    `evaluate`, its (metrics, scores), each computed once."""
    jax = evaluated.setdefault("jax", {})
    prepared = evaluated.setdefault("_jax_prepared", {})
    if stage not in prepared:
        prepared[stage] = jax_prepare(cycle_dir, "micro", "float32", stage,
                                      evaluated.setdefault("_jax_engines", {}))
    if evaluate and stage not in jax:
        jax[stage] = jax_evaluate(cycle_dir, "micro", *prepared[stage])
    return prepared[stage], jax.get(stage)


def test_witness_port_runs_the_three_stages(evaluated, cycle_dir):
    port = way(evaluated, cycle_dir, "port")
    rec = record(cycle_dir, "micro", "float32", {"port": port})
    assert sorted(rec["port"]) == ["fp", "int8_ptq", "int8_qat", "nds_drop_ptq", "nds_drop_qat"]
    for stage in ("fp", "int8_ptq", "int8_qat"):
        assert len(port[stage][1]) > 0, stage


def test_witness_float_tables_leave_floating_point_as_it_is(evaluated, cycle_dir):
    port = way(evaluated, cycle_dir, "port")
    float_tables = way(evaluated, cycle_dir, "port_float_tables")
    assert np.array_equal(port["fp"][1], float_tables["fp"][1])


def test_witness_scales_reach_the_jax_int8_layers(evaluated, cycle_dir):
    """The scales file attaches to the JAX package's int8 model: every scale
    at its site, and the int8 layers' weights folded from the checkpoint."""
    from flax import traverse_util

    from bevformer_tensorrt_tpu_torch.quant.observers import CalibrationResult

    (_, _, variables), _ = jax_stage(evaluated, cycle_dir, "int8_ptq", evaluate=False)
    flat = traverse_util.flatten_dict(variables["quant"])
    scales = CalibrationResult.load(str(cycle_dir / "scales.npz")).scales
    attached = {"/".join(p[:-1]): v for p, v in flat.items() if p[-1] == "scale"}
    assert attached and set(attached) <= set(scales)
    for name, v in attached.items():
        assert np.float32(v) == np.float32(scales[name]), name
    folded = [v for p, v in flat.items() if p[-1] == "wq"]
    assert folded and all(np.asarray(v).dtype == np.int8 for v in folded)


@pytest.mark.parametrize("stage", ["fp", "int8_ptq", "int8_qat"])
def test_witness_port_float_tables_give_jax_scores(evaluated, cycle_dir, stage):
    got = way(evaluated, cycle_dir, "port_float_tables")[stage][1]
    want = jax_stage(evaluated, cycle_dir, stage)[1][1]
    assert got.shape == want.shape and len(want) > 0, stage
    assert np.abs(got - want).max() <= SCORE_TOL[stage], stage


def test_witness_record_has_every_way(evaluated, cycle_dir):
    ways = {name: way(evaluated, cycle_dir, name) for name in ("port", "port_float_tables")}
    ways["jax"] = {stage: jax_stage(evaluated, cycle_dir, stage)[1] for stage, _, _ in STAGES}
    rec = record(cycle_dir, "micro", "float32", ways)
    for name in WAYS:
        assert sorted(rec[name]) == ["fp", "int8_ptq", "int8_qat", "nds_drop_ptq",
                                     "nds_drop_qat"], name


# `tools/quant_ablation.py` on the same cycle's files: its policies name the
# same sites in the port as in the JAX package, and one method x two policies
# write the JAX record.

@pytest.fixture(scope="module")
def jax_sites():
    """The JAX package's live QDQ sites of micro under a policy (its
    `amax_stats` collection, from `jax.eval_shape`: nothing compiled)."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from bevformer_tensorrt_tpu.configs import bevformer as cfgs
    from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer

    S, f32 = jax.ShapeDtypeStruct, jnp.float32

    def live(patterns):
        cfg = cfgs.bevformer_micro(quant=True, quant_exclude=tuple(patterns))
        nq = cfg.bev_h * cfg.bev_w
        args = (S((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), f32),
                S((nq, 1, cfg.embed_dims), f32), S((), f32), S((cfg.can_bus_dims,), f32),
                S((1, cfg.num_cams, 4, 4), f32))
        v = jax.eval_shape(BEVFormer(cfg).init, jax.random.PRNGKey(0), *args)
        return {"/".join(p[:-1]) for p in traverse_util.flatten_dict(v["amax_stats"])}

    cache = {}

    def cached(patterns):
        if tuple(patterns) not in cache:
            cache[tuple(patterns)] = live(patterns)
        return cache[tuple(patterns)]

    return cached


PSEUDO_SITES = ("/msda_tables", "/flash", "/dcn_tables")  # the JAX package's only on a TPU


@pytest.mark.parametrize("name", list(POLICIES))
def test_ablation_policies_exclude_the_jax_sites(jax_sites, name):
    from bevformer_tensorrt_tpu_torch.tools.quant_ablation import excluded_sites

    patterns = POLICIES[name]
    every = jax_sites(())
    port = excluded_sites("micro", patterns)
    assert {s for s in port if not s.endswith(PSEUDO_SITES)} == every - jax_sites(patterns)
    if name == "none":
        assert port == []
    elif name == "ref_mha_fp":
        # inherited: its glob must match a whole path from the root, so it
        # excludes nothing in either package (ABLATION_r4.json's rows equal
        # "none"'s)
        assert port == [] and every == jax_sites(patterns)
    else:
        assert port


def test_ablation_writes_the_jax_record(cycle_dir, tmp_path, monkeypatch):
    from bevformer_tensorrt_tpu_torch.tools import quant_ablation

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the stage processes run beside other tests
    out = tmp_path / "ablation.json"
    rec = quant_ablation.main(["--model", "micro", "--workdir", str(cycle_dir), "--methods", "max",
                               "--policies", "none,no_head", "--device", "cpu",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert {"model", "fp", "rows", "wall_s"} <= set(rec) and rec["device"] == "cpu"
    assert [(r["method"], r["policy"]) for r in rec["rows"]] == [("max", "none"),
                                                                 ("max", "no_head")]
    for r in rec["rows"]:
        assert {"method", "policy", "exclude", "NDS", "mAP", "nds_drop", "map_drop"} <= set(r)
        assert r["nds_drop"] == round(rec["fp"]["NDS"] - r["NDS"], 4)
        assert r["map_drop"] == round(rec["fp"]["mAP"] - r["mAP"], 4)
    assert rec["rows"][1]["exclude"] == quant_ablation.POLICIES["no_head"]
    assert rec["rows"][1]["sites_excluded"] > rec["rows"][0]["sites_excluded"] == 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
