"""Train BEVDet on a nuScenes-layout set (port of `tools/bevdet/train.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.bevdet.train --infos <infos.pkl>
        [--model r50] [--data-root DIR] [--checkpoint upstream.pth]
        [--quant-scales scales.npz] [--steps 5000] [--lr 2e-4] [--ranks-pad 400000]
        [--pool-impl interval] [--out checkpoints/bevdet.pth] [--log-every 10]
        [--limit N] [--device cuda]

One step is the image backbone -> LSS splat -> BEV encoder -> CenterHead
forward, the gaussian-focal heatmap and code-weighted L1 loss
(`train/losses_bevdet.py`), the backward and AdamW (weight decay 1e-2, the
gradients clipped at a global norm of 35, a linear warmup of
min(500, max(1, steps // 5)) steps and a cosine decay to 0).  The pooling
ranks come from the first frame's camera rig, as the deploy engine's
(`runtime/bevdet_engine.py::rig_ranks`); both splats of `ops/bev_pool.py`
are stock torch ops, so autograd carries the gradient to the depth and the
features.  Batches are one frame with its GT padded to 64 boxes (label -1),
shuffled every epoch with `np.random.default_rng(0)`, each loaded when its
step comes, as the JAX CLI does.  Float32.

`--quant-scales` (a `.npz` of `tools/bevdet/calibrate.py`, its
`.policy.json` beside it) is quantization-aware training: the model is
built with `quant=True` under the scales' policy, the scales are attached
to its QDQ sites and checked on the first step, and the default learning
rate is 1e-6 (an explicit `--lr` wins).

`--out` writes an upstream-layout state_dict (`.pth`), which
`tools/bevdet/{evaluate,calibrate}.py --checkpoint` read.  Runs on CUDA
unless `--device cpu` is given.
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

from ...configs.bevdet import BEVDetConfig
from ...models.detectors.bevdet import BEVDet
from ...quant.fold import attach_quant_scales
from ...quant.observers import CalibrationResult
from ...quant.policy import load_policy
from ...runtime.bevdet_engine import POOL_IMPLS, rig_ranks
from ...runtime.engine import resolve_device
from ...runtime.torch_import import bevdet_upstream_layout
from ...train.losses_bevdet import bevdet_loss_single
from ...train.step import Optimizer, check_quant_scales
from ...weights import init_weights
from ..train import pad_gt
from .evaluate import MODELS, checkpoint_state_dict, frames_of, make_config

MAX_GT = 64
SCALARS = ("loss", "loss_heatmap", "loss_bbox", "num_pos")


def frame_batch(frame) -> Dict[str, np.ndarray]:
    """One frame: its image and its GT padded to MAX_GT rows (label -1)."""
    gb, gl = pad_gt(frame, MAX_GT)
    return {"image": frame.image.astype(np.float32), "gt_boxes": gb, "gt_labels": gl}


def batch_iter(frames, n_frames: int, device) -> Iterator[Dict[str, torch.Tensor]]:
    """The first `n_frames` frames in the JAX CLI's order (shuffled with
    seed 0 every epoch), each loaded and moved to `device` in its turn."""
    idx = np.arange(n_frames)
    rng = np.random.default_rng(0)
    while True:
        rng.shuffle(idx)
        for i in idx:
            yield {k: torch.from_numpy(v).to(device)
                   for k, v in frame_batch(frames.frame(int(i))).items()}


def loss_fn(model: BEVDet, rank_args, batch) -> Dict[str, torch.Tensor]:
    """One frame's loss (`bevdet_loss_single`) through the model."""
    heads = model(batch["image"], *rank_args)
    return bevdet_loss_single(model.cfg, heads, batch["gt_boxes"], batch["gt_labels"])


def train_step(model: BEVDet, optimizer: Optimizer, rank_args, batch) -> Dict[str, torch.Tensor]:
    """Loss, backward, update (QAT for a model built with `quant=True`,
    checked by `check_quant_scales` on the first step).  Returns the
    metrics as detached device tensors."""
    if optimizer.count == 0:
        check_quant_scales(model)
    optimizer.zero_grad()
    metrics = loss_fn(model, rank_args, batch)
    metrics["loss"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def make_optimizer(model: BEVDet, lr: float, steps: int) -> Optimizer:
    """The JAX CLI's chain: clip at 35, AdamW with weight decay 1e-2 on a
    warmup-cosine schedule that ends at 0, one rate for every parameter."""
    warmup = min(500, max(1, steps // 5))
    return Optimizer(model, learning_rate=lr, weight_decay=1e-2, backbone_lr_mult=1.0,
                     total_steps=steps, warmup_steps=warmup, grad_clip=35.0, end_fraction=0.0)


def save(cfg: BEVDetConfig, model: BEVDet, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(bevdet_upstream_layout(cfg, sd), path)


@dataclasses.dataclass
class TrainResult:
    """What `main` ran: the config, the trained model, its optimizer and
    rank tensors, and each step's metrics as floats."""

    cfg: BEVDetConfig
    model: BEVDet
    optimizer: Optimizer
    rank_args: tuple
    metrics: List[Dict[str, float]]
    out: str


def main(argv=None) -> TrainResult:
    """Parse `argv`, train, save; the result is returned for callers that
    drive the tool from Python."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r50", choices=MODELS)
    ap.add_argument("--infos", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="start from this upstream-layout state_dict (.pth)")
    ap.add_argument("--quant-scales", default=None,
                    help="quantization-aware training from these scales (.npz of "
                         "tools/bevdet/calibrate.py, with its policy)")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--lr", type=float, default=None,
                    help="peak lr (default 2e-4; 1e-6 with --quant-scales, the reference's "
                         "1-epoch tiny-lr QAT recipe; an explicit --lr overrides both)")
    ap.add_argument("--ranks-pad", type=int, default=400000)
    ap.add_argument("--pool-impl", default="interval", choices=POOL_IMPLS)
    ap.add_argument("--out", default="checkpoints/bevdet.pth",
                    help="upstream-layout state_dict written at the end")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--limit", type=int, default=None,
                    help="restrict to the first N frames (overfit runs)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    qat = args.quant_scales is not None
    over = dict(quant=True, quant_exclude=load_policy(args.quant_scales)) if qat else {}
    cfg = make_config(args.model, **over)
    frames = frames_of(cfg, args.infos, args.data_root)
    n_frames = len(frames) if args.limit is None else min(args.limit, len(frames))
    use_iv = args.pool_impl == "interval"
    ranks = rig_ranks(cfg, frames.infos[0], args.ranks_pad, intervals=use_iv)
    arrays = (ranks.ranks_depth, ranks.ranks_feat, ranks.ranks_bev) + (
        (ranks.interval_starts, ranks.interval_lengths) if use_iv else ())
    rank_args = tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
                      for a in arrays)

    model = BEVDet(cfg)
    if args.checkpoint:
        model.load_state_dict(checkpoint_state_dict(cfg, args.checkpoint), strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).train()
    if qat:
        scales = CalibrationResult.load(args.quant_scales).scales
        attach_quant_scales(model, scales)
        print(f"QAT: {len(scales)} scales from {args.quant_scales}, policy "
              f"{list(cfg.quant_exclude)}", file=sys.stderr)
    lr = args.lr if args.lr is not None else (1e-6 if qat else 2e-4)
    optimizer = make_optimizer(model, lr, args.steps)

    it = batch_iter(frames, n_frames, device)
    history: List[Dict[str, torch.Tensor]] = []  # read back on logged steps and at the end
    t0 = time.perf_counter()
    for step in range(args.steps):
        metrics = train_step(model, optimizer, rank_args, next(it))
        history.append({k: metrics[k] for k in SCALARS})
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in history[-1].items()}
            dt = time.perf_counter() - t0
            print(f"step {step}: loss {m['loss']:.4f} (hm {m['loss_heatmap']:.4f} bbox "
                  f"{m['loss_bbox']:.4f}) num_pos {m['num_pos']:.0f} ({dt / (step + 1):.2f}s/step)",
                  file=sys.stderr, flush=True)
    save(cfg, model, args.out)
    print(f"saved -> {args.out}")
    floats = [{k: float(v) for k, v in m.items()} for m in history]
    return TrainResult(cfg, model, optimizer, rank_args, floats, args.out)


if __name__ == "__main__":
    main()
