"""Train or QAT-fine-tune YOLOX or CenterNet on a COCO-format set (port of
`tools/2d/train.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.det2d.train <model> --ann <instances.json>
        --img-root DIR [--checkpoint upstream.pth] [--quant-scales scales.npz]
        [--steps 1000] [--batch 8] [--lr LR] [--out checkpoints/2d.pth]
        [--log-every 10] [--no-augment] [--device cuda]

`model` is one of yolox_x, yolox_s, yolox_micro, centernet_r18 and
centernet_micro.  One step is the detector's forward on a batch, the
criterion of `train/losses2d.py` image by image (YOLOX: SimOTA, then the
IoU, class and objectness losses; CenterNet: the gaussian focal heatmap and
the wh and offset L1) averaged over the batch, the backward and the JAX
recipe's update: the gradients clipped at a global norm of 35, then AdamW
with weight decay 1e-4 at a constant rate, 1e-4 by default (the
`train/step.py::Optimizer`, whose in-place update moves every parameter's
version, on which CenterNet-R18's DCN keys its kept weight matrix).  The
port's detectors return NCHW maps; the criterion takes them NHWC, as the
JAX package's, so the maps are transposed at that boundary (`nhwc`).

Batches are `--batch` images of `data/coco.py::CocoDataset.train_sample`
with their GT padded to 64 rows (label -1), in an order shuffled with
`np.random.default_rng(0)` every epoch, each loaded when its step comes, as
the JAX CLI does.  Augmentation (`data/transforms2d.py`) is on unless
`--no-augment`: YOLOX's whole pipeline (mosaic, affine, mixup, HSV, flip),
CenterNet's HSV and flip only.  CenterNet trains on ImageNet-normalized RGB,
the evaluator's norm (`runtime/det2d_engine.py::image_norm`).

`--quant-scales` (a `.npz` of `tools/det2d/calibrate.py`, its
`.policy.json` beside it) is quantization-aware training: the model is
built with `quant=True` under the scales' policy, the scales are attached
to its QDQ sites and checked on the first step, and the default rate is
1e-6 (an explicit `--lr` wins).  `--out` writes an upstream-layout
state_dict (`.pth`), which `tools/det2d/{evaluate,calibrate,export}.py
--checkpoint` read.  Float32.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np
import torch

from ...data.coco import CocoDataset
from ...data.transforms2d import YoloxTrainAugment
from ...models.detectors.centernet import CenterNet
from ...models.detectors.yolox import YOLOX
from ...quant.fold import attach_quant_scales
from ...quant.observers import CalibrationResult
from ...quant.policy import load_policy
from ...runtime.det2d_engine import MODELS, is_yolox, load_checkpoint_state_dict, make_config
from ...runtime.engine import resolve_device
from ...runtime.torch_import import (
    centernet_upstream_layout,
    load_torch_checkpoint,
    yolox_upstream_layout,
)
from ...train.losses2d import centernet_loss_single, yolox_loss_single
from ...train.step import Optimizer, check_quant_scales
from ...weights import init_weights
from .evaluate import dataset_of

MAX_GT = 64
TERMS = {"yolox": ("loss", "loss_cls", "loss_obj", "loss_bbox"),
         "centernet": ("loss", "loss_heatmap", "loss_wh", "loss_offset")}


def family(cfg) -> str:
    return "yolox" if cfg.name.startswith("yolox") else "centernet"


def nhwc(heads):
    """The detector's NCHW maps (YOLOX: per level {cls, reg, obj}; CenterNet:
    {heatmap, wh, offset}) as the criterion takes them, NHWC."""
    if isinstance(heads, dict):
        return {k: v.permute(0, 2, 3, 1) for k, v in heads.items()}
    return [nhwc(o) for o in heads]


def loss_fn(model, batch, assigned=None) -> Dict:
    """The batch's loss through the model: each image's terms (as the JAX
    CLI's per-image loop), their means over the batch, num_pos summed, and
    for YOLOX each image's SimOTA assignment (fg, best_gt) under
    "assigned".  `assigned` (such a list) replays a given assignment."""
    cfg = model.cfg
    heads = nhwc(model(batch["image"]))
    n = batch["image"].shape[0]
    per = []
    for i in range(n):
        gb, gl = batch["gt_boxes"][i], batch["gt_labels"][i]
        if family(cfg) == "yolox":
            per.append(yolox_loss_single(heads, gb, gl, cfg.num_classes, img_idx=i,
                                         assigned=None if assigned is None else assigned[i]))
        else:
            per.append(centernet_loss_single(heads, gb, gl, cfg.num_classes, stride=4,
                                             img_idx=i))
    out = {k: sum(p[k] for p in per) / n for k in TERMS[family(cfg)]}
    out["num_pos"] = sum(p["num_pos"] for p in per)
    if family(cfg) == "yolox":
        out["assigned"] = [(p["fg"], p["best_gt"]) for p in per]
    return out


def train_step(model, optimizer: Optimizer, batch) -> Dict[str, torch.Tensor]:
    """Loss, backward, update (QAT for a model built with `quant=True`,
    checked by `check_quant_scales` on the first step).  Returns the scalar
    metrics as detached device tensors."""
    if optimizer.count == 0:
        check_quant_scales(model)
    optimizer.zero_grad()
    metrics = loss_fn(model, batch)
    metrics["loss"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items() if k != "assigned"}


def make_optimizer(model, lr: float) -> Optimizer:
    """The JAX CLI's chain: clip at 35, AdamW with weight decay 1e-4 at a
    constant rate, one rate for every parameter."""
    return Optimizer(model, learning_rate=lr, weight_decay=1e-4, backbone_lr_mult=1.0,
                     total_steps=None, grad_clip=35.0)


def pad_gt(boxes: np.ndarray, labels: np.ndarray):
    """(gt_boxes [MAX_GT, 4], gt_labels [MAX_GT]) with -1 padding."""
    gb = np.zeros((MAX_GT, 4), np.float32)
    gl = np.full(MAX_GT, -1, np.int64)
    k = min(len(boxes), MAX_GT)
    gb[:k] = boxes[:k]
    gl[:k] = labels[:k]
    return gb, gl


def load_batch(ds: CocoDataset, indices, augment) -> Dict[str, np.ndarray]:
    """The training views of `indices`, stacked, GT padded."""
    imgs, gbs, gls = [], [], []
    for i in indices:
        img, boxes, labels = ds.train_sample(int(i), augment)
        gb, gl = pad_gt(boxes, labels)
        imgs.append(img)
        gbs.append(gb)
        gls.append(gl)
    return {"image": np.stack(imgs), "gt_boxes": np.stack(gbs), "gt_labels": np.stack(gls)}


def batch_iter(ds: CocoDataset, batch: int, augment, device) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches in the JAX CLI's order (shuffled with seed 0 every epoch, a
    short tail dropped), each loaded and moved to `device` in its turn."""
    idx = np.arange(len(ds))
    rng = np.random.default_rng(0)
    while True:
        rng.shuffle(idx)
        for s in range(0, len(idx) - batch + 1, batch):
            yield {k: torch.from_numpy(v).to(device)
                   for k, v in load_batch(ds, idx[s:s + batch], augment).items()}


def save(cfg, model, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    up = yolox_upstream_layout if family(cfg) == "yolox" else centernet_upstream_layout
    torch.save(up(cfg, sd), path)


@dataclasses.dataclass
class TrainResult:
    """What `main` ran: the config, the trained model, its optimizer, the
    data set and each step's metrics as floats."""

    cfg: object
    model: torch.nn.Module
    optimizer: Optimizer
    dataset: CocoDataset
    metrics: List[Dict[str, float]]
    out: str


def build_model(model_name: str, cfg, checkpoint, device):
    """The detector of `cfg` from an upstream-layout `checkpoint`, or seeded
    (seed 0), on `device` in train mode."""
    model = (YOLOX if is_yolox(model_name) else CenterNet)(cfg)
    if checkpoint:
        model.load_state_dict(load_checkpoint_state_dict(cfg, load_torch_checkpoint(checkpoint)),
                              strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device).train()


def main(argv=None) -> TrainResult:
    """Parse `argv`, train, save; the result is returned for callers that
    drive the tool from Python."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="start from this upstream-layout state_dict (.pth)")
    ap.add_argument("--quant-scales", default=None,
                    help="quantization-aware training from these scales (.npz of "
                         "tools/det2d/calibrate.py, with its policy)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=None,
                    help="lr (default 1e-4; 1e-6 with --quant-scales, the reference's 1-epoch "
                         "tiny-lr QAT recipe; an explicit --lr overrides both)")
    ap.add_argument("--out", default="checkpoints/2d.pth",
                    help="upstream-layout state_dict written at the end")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-augment", action="store_true",
                    help="no train augmentation (YOLOX: mosaic / affine / mixup / HSV / flip, "
                         "reference yolox_x_8x8_300e_coco.py:33-52; CenterNet: HSV / flip)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    qat = args.quant_scales is not None
    over = dict(quant=True, quant_exclude=load_policy(args.quant_scales)) if qat else {}
    cfg = make_config(args.model, **over)
    ds = dataset_of(args.model, cfg, args.ann, args.img_root)
    augment = None
    if not args.no_augment:  # CenterNet's reference pipeline has no mosaic or mixup
        augment = YoloxTrainAugment(img_scale=cfg.img_size, enable_mosaic=is_yolox(args.model),
                                    enable_mixup=is_yolox(args.model))
    model = build_model(args.model, cfg, args.checkpoint, device)
    if qat:
        scales = CalibrationResult.load(args.quant_scales).scales
        attach_quant_scales(model, scales)
        print(f"QAT: {len(scales)} scales from {args.quant_scales}, policy "
              f"{list(cfg.quant_exclude)}", file=sys.stderr)
    lr = args.lr if args.lr is not None else (1e-6 if qat else 1e-4)
    optimizer = make_optimizer(model, lr)

    it = batch_iter(ds, args.batch, augment, device)
    history: List[Dict[str, torch.Tensor]] = []  # read back on logged steps and at the end
    t0 = time.perf_counter()
    for step in range(args.steps):
        history.append(train_step(model, optimizer, next(it)))
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in history[-1].items()}
            terms = " ".join(f"{k[5:]} {m[k]:.4f}" for k in TERMS[family(cfg)][1:])
            dt = time.perf_counter() - t0
            print(f"step {step}: loss {m['loss']:.4f} ({terms}) num_pos {m['num_pos']:.0f} "
                  f"({dt / (step + 1):.2f}s/step)", file=sys.stderr, flush=True)
    save(cfg, model, args.out)
    print(f"saved -> {args.out}")
    floats = [{k: float(v) for k, v in m.items()} for m in history]
    return TrainResult(cfg, model, optimizer, ds, floats, args.out)


if __name__ == "__main__":
    main()
