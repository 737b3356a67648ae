"""The port's 2D CLIs on a generated COCO-format set on the CPU (micro):
`tools/det2d/evaluate.py` against the JAX tool's pipeline on the same
loader batches, its pipelined loop against a serial one, and
`tools/det2d/calibrate.py` against the JAX tool's procedure, then int8 and
QDQ evaluations from those scales.  A file of its own: it compiles the JAX
micro detectors."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from bevformer_tensorrt_tpu.configs import centernet as jax_centernet_cfg
from bevformer_tensorrt_tpu.configs import yolox as jax_yolox_cfg
from bevformer_tensorrt_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from bevformer_tensorrt_tpu.models.detectors.yolox import YOLOX as JaxYOLOX
from bevformer_tensorrt_tpu.models.heads.centernet_head import (
    centernet_decode as jax_centernet_decode,
)
from bevformer_tensorrt_tpu.models.heads.yolox_head import yolox_decode as jax_yolox_decode
from bevformer_tensorrt_tpu.models.heads.yolox_head import (
    yolox_post_process as jax_yolox_post_process,
)
from bevformer_tensorrt_tpu.quant import policy as jax_policy
from bevformer_tensorrt_tpu.quant.calibrate import collect_stats as jax_collect_stats
from bevformer_tensorrt_tpu.quant.calibrate import scales_from_stats as jax_scales_from_stats
from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
from bevformer_tensorrt_tpu_torch.quant.observers import CalibrationResult
from bevformer_tensorrt_tpu_torch.quant.policy import load_policy
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    centernet_upstream_layout,
    yolox_upstream_layout,
)
from bevformer_tensorrt_tpu_torch.tools.det2d import calibrate, evaluate
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import random_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ANN = "instances_synthetic.json"


@pytest.fixture(scope="module")
def coco_case(tmp_path_factory):
    """A generated set of 7 images (a short last batch at --batch 4) and
    seeded upstream-layout checkpoints of both micro models, with the flax
    variables the JAX tools take.  YOLOX's stem conv is scaled by 1/64: it
    takes raw pixels (0-255), which weights drawn for unit inputs carry into
    an overflow of exp() in the box sizes."""
    tmp = tmp_path_factory.mktemp("det2d")
    root = tmp / "set"
    subprocess.run([sys.executable, str(REPO / "tools/make_synthetic_coco.py"), str(root),
                    "--images", "7", "--size", "96"], check=True, capture_output=True,
                   timeout=120)
    yvars = random_variables(JaxYOLOX(jax_yolox_cfg.yolox_micro()), np.random.default_rng(3),
                             np.zeros((1, 3, 64, 64), np.float32))
    stem = yvars["params"]["backbone"]["stem"]["conv"]["conv"]
    stem["kernel"] = stem["kernel"] / np.float32(64)
    torch.save(yolox_upstream_layout(yolox_micro(), params_from_jax(yvars)), tmp / "yolox.pth")
    cvars = random_variables(JaxCenterNet(jax_centernet_cfg.centernet_micro()),
                             np.random.default_rng(4),
                             np.zeros((1, 3, 64, 64), np.float32))
    torch.save(centernet_upstream_layout(centernet_micro(), params_from_jax(cvars)),
               tmp / "centernet.pth")
    variables = {"yolox_micro": yvars, "centernet_micro": cvars}
    return tmp, root, variables


def _args(model, tmp, root):
    return [model, "--ann", str(root / ANN), "--img-root", str(root / "images"), "--batch", "4",
            "--checkpoint", str(tmp / f"{model.split('_')[0]}.pth"), "--device", "cpu"]


def _jax_detections(model, variables, ds, indices, batch):
    """The JAX tool's pipeline (tools/2d/evaluate.py) on the same loader
    batches: each image's (boxes, scores, labels) in original pixels."""
    yolox = model.startswith("yolox")
    jcfg = getattr(jax_yolox_cfg if yolox else jax_centernet_cfg, model)()
    net = (JaxYOLOX if yolox else JaxCenterNet)(jcfg)
    jax_policy.set_quant_exclude(())
    apply = jax.jit(net.apply)
    out = []
    for s in range(0, len(indices), batch):
        samples = [ds.sample(i) for i in indices[s:s + batch]]
        imgs = evaluate.batch_images(samples, batch, jcfg.img_size)
        heads = apply(variables, jnp.asarray(imgs))
        for i, sm in enumerate(samples):
            if yolox:
                boxes, scores = jax_yolox_decode(heads)
                b, sc, lab = jax_yolox_post_process(np.asarray(boxes[i]), np.asarray(scores[i]),
                                                    jcfg.score_thr, jcfg.nms_iou,
                                                    jcfg.max_per_img)
                out.append((b / sm.scale, sc, lab))
            else:
                boxes, scores, labels = jax_centernet_decode(heads, k=jcfg.topk,
                                                             kernel=jcfg.local_max_kernel)
                keep = np.asarray(scores[i]) > 0.01
                out.append((np.asarray(boxes[i])[keep] / sm.scale, np.asarray(scores[i])[keep],
                            np.asarray(labels[i])[keep]))
    return out


@pytest.mark.parametrize("model", ["yolox_micro", "centernet_micro"])
def test_evaluate_cli_matches_the_jax_pipeline(model, coco_case):
    """tools/det2d/evaluate.py from an upstream-layout `.pth` against the
    JAX tool's pipeline on the same batches: the same number of detections
    per image, boxes and scores within 1e-4, the same labels; finite mAP
    and fps; the serial loop gives the pipelined loop's detections."""
    tmp, root, variables = coco_case
    res = evaluate.main(_args(model, tmp, root))
    assert len(res.run.detections) == 7 and len(res.run.latencies) == 2
    assert set(res.metrics) == {"mAP", "mAP_50", "mAP_75", "fps"}
    assert all(np.isfinite(v) for v in res.metrics.values())
    want = _jax_detections(model, variables[model], res.dataset, res.indices, res.batch)
    kept = 0
    for i, ((gb, gs, gl), (wb, ws, wl)) in enumerate(zip(res.run.detections, want)):
        assert len(gb) == len(wb), (model, i)
        np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(gl, wl)
        kept += len(gb)
    assert kept > 0
    serial = evaluate.eval_loop(res.engine, res.dataset, res.indices, res.batch, pipelined=False)
    for a, b in zip(serial.detections, res.run.detections):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("model", ["yolox_micro", "centernet_micro"])
def test_calibrate_cli_matches_the_jax_procedure(model, coco_case):
    """tools/det2d/calibrate.py (`max`) against the JAX tool's procedure on
    the same zero-padded batches: the same sites, scales within 1e-5; the
    policy beside them; then int8 (the default) and QDQ evaluations from
    them, the int8 one with its weights folded."""
    tmp, root, variables = coco_case
    out = str(tmp / f"{model}.npz")
    result = calibrate.main(_args(model, tmp, root) + ["--length", "6", "--method", "max",
                                                        "--exclude", "bbox_head", "--out", out])
    assert CalibrationResult.load(out).scales == pytest.approx(result.scales)
    assert load_policy(out) == ("bbox_head",)
    yolox = model.startswith("yolox")
    jcfg = getattr(jax_yolox_cfg if yolox else jax_centernet_cfg, model)(quant=True)
    net = (JaxYOLOX if yolox else JaxCenterNet)(jcfg)
    ds = evaluate.dataset_of(model, jcfg, str(root / ANN), str(root / "images"))
    batches = [{"image": evaluate.batch_images([ds.sample(i) for i in range(s, min(s + 4, 6))],
                                               4, jcfg.img_size)} for s in (0, 4)]
    jax_policy.set_quant_exclude(())

    def apply_fn(v, batch, mutable):
        return net.apply(v, jnp.asarray(batch["image"]), mutable=mutable)[1]

    amax, hist = jax_collect_stats(apply_fn, variables[model], batches, with_hist=False)
    want = jax_scales_from_stats(amax, hist, method="max")[1].scales
    assert sorted(result.scales) == sorted(want)
    for name, scale in want.items():
        assert result.scales[name] == pytest.approx(scale, rel=1e-5), name
    flat = traverse_util.flatten_dict(amax)
    assert len(flat) == len(want) > 10
    ev8 = evaluate.main(_args(model, tmp, root) + ["--quant-scales", out])
    assert ev8.engine.cfg.quant == "int8" and ev8.engine.cfg.quant_exclude == ("bbox_head",)
    assert ev8.engine.model.backbone.stem_conv.wq.dtype == torch.int8 if not yolox else (
        ev8.engine.model.backbone.stem.conv.conv.wq.dtype == torch.int8)
    assert all(np.isfinite(v) for v in ev8.metrics.values())
    qdq = evaluate.main(_args(model, tmp, root) + ["--quant-scales", out, "--quant", "qdq",
                                                   "--quant-exclude", ""])
    assert qdq.engine.cfg.quant is True and qdq.engine.cfg.quant_exclude == ()
    assert all(np.isfinite(v) for v in qdq.metrics.values())
