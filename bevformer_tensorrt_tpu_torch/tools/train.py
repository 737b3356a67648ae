"""Train BEVFormer on a nuScenes-layout set (port of `tools/bevformer/train.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.train <micro|tiny|small|base> --infos <infos.pkl>
        [--data-root DIR] [--temporal [--queue-length 4]] [--encoder-layers N]
        [--decoder-layers N] [--steps 1000] [--lr 2e-4] [--warmup N]
        [--quant-scales scales.npz]
        [--out checkpoints/bevformer.pth] [--resume FILE | --checkpoint FILE]
        [--save-every 1000] [--log-every 10] [--no-augment] [--aug-scales S ...]
        [--device cuda] [--distributed]

    torchrun --nproc-per-node 4 -m bevformer_tensorrt_tpu_torch.tools.train tiny \
        --infos <infos.pkl> --distributed

The loader (`data/nuscenes.py`, with the train pipeline's photometric
augmentation) feeds `train/step.py`: the model's forward (the MSDA and flash
kernels on CUDA), the DETR loss with Hungarian matching on every decoder
level, the backward and the AdamW recipe.  A step takes one sample a
data-parallel rank (a frame, or with `--temporal` a clip of
`--queue-length` same-scene frames whose first frames build prev_bev
without gradients).  A set of at most 64 frames (not with `--temporal`) is
an overfit run: every batch is kept on the device once and the order
reshuffled (seed 1).  Float32, as the JAX trainer.

`--distributed` (or torchrun's variables in the environment) joins the job
torchrun describes: one process a card, NCCL on `cuda:LOCAL_RANK` (gloo
with `--device cpu`), the world laid out by `parallel.make_mesh()` (at 4
processes dp1 x tp4: tensor parallelism first, as the JAX CLI's mesh).
Every rank starts from rank 0's weights, shuffles with seed 0 and loads
only its dp share of each global batch of dp samples; the transformer is
sharded over tp (`parallel.shard_parameters`); the gradients are summed
over dp.  Rank 0 prints the metrics (the global batch's) and saves the
gathered weights.

`--quant-scales` (a `.npz` of `tools/calibrate.py`, its `.policy.json`
beside it) is quantization-aware training, the reference's QAT fine-tune:
the model is built with `quant=True` under the scales' policy, the scales
are attached to its QDQ sites (fixed; no int8 weights are folded), and the
default learning rate is 1e-6 (an explicit `--lr` wins).

`--out` writes an upstream-layout state_dict (`.pth`) of the weights alone,
which `tools/evaluate.py --checkpoint` reads (with `--quant-scales ...
--quant int8` it folds the int8 weights anew from them); `--resume` and
`--checkpoint` read one.  Left out (the JAX CLI has it): `--msda-impl` (on
the card the kernel forward is always used, the JAX `sorted` choice; the
plain path is the CPU's).  Runs on CUDA unless `--device cpu` is given.
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
import torch.distributed as dist

from ..configs import bevformer as configs
from ..data.nuscenes import IMG_NORM_CAFFE, IMG_NORM_PYTORCH, NuScenesFrames, TemporalClipSampler
from ..data.transforms import MultiViewTrainAugment, RandomScaleImage
from ..models.modules.encoder import cam_budget_overflow
from ..parallel import comm, gather_state_dict, init_distributed, make_mesh, shard_parameters
from ..parallel.mesh import in_torchrun
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from ..quant.policy import load_policy
from ..runtime.engine import resolve_device
from ..runtime.torch_import import (
    load_bevformer_checkpoint,
    load_torch_checkpoint,
    upstream_layout,
)
from ..train import Optimizer, init_train_state, temporal_train_step, train_step

MODELS = ("micro", "tiny", "small", "base")
MAX_GT = 64  # clamped to num_query (the matching needs rows <= cols)
OVERFIT_BATCHES = 64  # a set of at most this many distinct batches is kept on the device
SCALARS = ("loss", "loss_cls", "loss_bbox", "num_pos")  # the metrics a step records


def image_norm(model: str):
    """tiny and micro train with the pytorch-style norm, the R101 configs
    with the caffe-style one (the JAX trainer's rule)."""
    return IMG_NORM_PYTORCH if model in ("tiny", "micro") else IMG_NORM_CAFFE


def pad_gt(frame, max_gt: int):
    """(gt_boxes [max_gt, 9], gt_labels [max_gt]) with -1 padding."""
    gb = np.zeros((max_gt, 9), np.float32)
    gl = np.full(max_gt, -1, np.int64)
    k = min(len(frame.gt_labels), max_gt)
    gb[:k] = frame.gt_boxes[:k]
    gl[:k] = frame.gt_labels[:k]
    return gb, gl


def frame_batch(frames, max_gt: int) -> Dict[str, np.ndarray]:
    """One sample: a frame, or a clip (its GT from the last frame)."""
    gb, gl = pad_gt(frames[-1], max_gt)
    if len(frames) == 1:
        f = frames[0]
        sample = dict(image=f.image[0], can_bus=f.can_bus, lidar2img=f.lidar2img)
    else:
        sample = dict(image=np.stack([f.image[0] for f in frames]),
                      can_bus=np.stack([f.can_bus for f in frames]),
                      lidar2img=np.stack([f.lidar2img for f in frames]))
    return {**{k: v[None] for k, v in sample.items()}, "gt_boxes": gb[None], "gt_labels": gl[None]}


def batch_iter(frames: NuScenesFrames, max_gt: int, dp: int = 1,
               rank: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Single-frame batches of one sample, shuffled with seed 0 every epoch
    (the JAX CLI's `batch_iter`): each global batch is dp consecutive
    indices of the order, of which dp rank `rank` loads its own."""
    idx = np.arange(len(frames))
    rng = np.random.default_rng(0)
    while True:
        rng.shuffle(idx)
        for s in range(0, len(idx) - dp + 1, dp):
            yield frame_batch([frames.frame(int(idx[s + rank]))], max_gt)


def temporal_batch_iter(frames: NuScenesFrames, queue_length: int, max_gt: int, dp: int = 1,
                        rank: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Clip batches of one sample: queue_length consecutive same-scene
    frames with relative can_bus deltas (`TemporalClipSampler`), split over
    dp as `batch_iter`."""
    clips = TemporalClipSampler(frames, queue_length=queue_length)
    if len(clips) < dp:
        raise SystemExit(f"--temporal needs >= dp ({dp}) clips of length {queue_length}; the "
                         f"set has {len(clips)}")
    idx = np.arange(len(clips))
    rng = np.random.default_rng(0)
    while True:
        rng.shuffle(idx)
        for s in range(0, len(idx) - dp + 1, dp):
            yield frame_batch(clips.clip(int(idx[s + rank])), max_gt)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def cached_iter(batches: List[Dict[str, torch.Tensor]]):
    """The device-resident batches of an overfit run, reshuffled (seed 1)."""
    rng = np.random.default_rng(1)
    order = np.arange(len(batches))
    while True:
        rng.shuffle(order)
        for k in order:
            yield batches[int(k)]


def save(cfg, model, path: str, mesh=None, specs=None) -> None:
    """The upstream-layout weights; under `mesh` the tp shards are gathered
    (a collective: every rank calls it) and rank 0 writes."""
    sd = model.state_dict() if mesh is None else gather_state_dict(model, mesh, specs)
    if mesh is not None and mesh.rank != 0:
        return
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    torch.save(upstream_layout(cfg, sd), path)


def sync_initial_weights(model: torch.nn.Module) -> None:
    """Every rank starts from rank 0's parameters and buffers (one
    broadcast over the world, before any shard)."""
    for t in list(model.parameters()) + list(model.buffers()):
        comm.broadcast_world(t.data, src=0)


@dataclasses.dataclass
class TrainResult:
    """What `main` ran: the config, the trained model and its optimizer,
    each step's metrics as floats, and each step's host seconds."""

    cfg: configs.BEVFormerConfig
    model: torch.nn.Module
    optimizer: object
    metrics: List[Dict[str, float]]
    step_seconds: List[float]
    out: str


def main(argv=None) -> TrainResult:
    """Parse `argv`, train, save; the result is returned for callers that
    drive the tool from Python."""
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not ported from the JAX CLI: --msda-impl.")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--infos", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="start from this upstream-layout state_dict (.pth)")
    ap.add_argument("--temporal", action="store_true",
                    help="temporal-queue training: clips of --queue-length same-scene frames, "
                         "the first ones without gradients build prev_bev, the last trains "
                         "(reference BEVFormer.forward_train + obtain_history_bev)")
    ap.add_argument("--queue-length", type=int, default=4,
                    help="frames per temporal clip (reference queue_length=4)")
    ap.add_argument("--encoder-layers", type=int, default=None,
                    help="override the encoder depth (smoke runs, ablations)")
    ap.add_argument("--decoder-layers", type=int, default=None,
                    help="override the decoder depth (smoke runs, ablations)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--quant-scales", default=None,
                    help="quantization-aware training from these calibrated scales (.npz of "
                         "tools/calibrate.py, with its policy)")
    ap.add_argument("--lr", type=float, default=None,
                    help="peak learning rate (default 2e-4; 1e-6 with --quant-scales, the "
                         "reference's QAT recipe)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="linear warmup steps (default min(500, steps // 5))")
    ap.add_argument("--out", default="checkpoints/bevformer.pth",
                    help="upstream-layout state_dict written at the end (and every --save-every)")
    ap.add_argument("--resume", default=None,
                    help="start from a prior --out checkpoint (the optimizer starts anew)")
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-augment", action="store_true",
                    help="no photometric augmentation (reference "
                         "PhotoMetricDistortionMultiViewImage)")
    ap.add_argument("--aug-scales", type=float, nargs="*", default=None,
                    help="optional RandomScaleImageMultiViewImage scales (e.g. 0.8)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the job torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK, "
                         "MASTER_ADDR, MASTER_PORT; also implied when they are set): dp x tp "
                         "over the world, NCCL on cuda:LOCAL_RANK, gloo on the CPU")
    args = ap.parse_args(argv)

    mesh = None
    if args.distributed or in_torchrun():
        device, _, _ = init_distributed(args.device)
        mesh = make_mesh()
    else:
        device = resolve_device(args.device)
    dp, dp_rank = (1, 0) if mesh is None else (mesh.axis_size("dp"), mesh.axis_index("dp"))
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and lead:
        print(f"mesh: {mesh.describe()} over {mesh.size} process(es), {mesh.backend}",
              file=sys.stderr)
    over = {k: v for k, v in (("encoder_layers", args.encoder_layers),
                              ("decoder_layers", args.decoder_layers)) if v is not None}
    qat = args.quant_scales is not None
    if qat:  # the QDQ tier under the policy the scales were saved with
        over.update(quant=True, quant_exclude=load_policy(args.quant_scales))
    cfg = getattr(configs, f"bevformer_{args.model}")(**over)
    augment = None
    if not args.no_augment:
        augment = MultiViewTrainAugment(
            scale=RandomScaleImage(args.aug_scales) if args.aug_scales else None)
    frames = NuScenesFrames(args.infos, args.data_root, img_norm=image_norm(args.model),
                            target_hw=(cfg.img_h, cfg.img_w), augment=augment)
    max_gt = min(MAX_GT, cfg.num_query)
    lr = args.lr if args.lr is not None else (1e-6 if qat else 2e-4)
    warmup = args.warmup if args.warmup is not None else min(500, args.steps // 5)
    opt_kw = dict(learning_rate=lr, total_steps=args.steps, warmup_steps=warmup)
    model, optimizer = init_train_state(cfg, device, **opt_kw)
    start_from = args.resume or args.checkpoint
    if start_from:
        model.load_state_dict(load_bevformer_checkpoint(cfg, load_torch_checkpoint(start_from)),
                              strict=True)
    if qat:
        scales = CalibrationResult.load(args.quant_scales).scales
        attach_quant_scales(model, scales)
        print(f"QAT: {len(scales)} scales from {args.quant_scales}, policy "
              f"{list(cfg.quant_exclude)}", file=sys.stderr)
    specs = None
    if mesh is not None:
        sync_initial_weights(model)
        specs = shard_parameters(model, mesh)
        optimizer = Optimizer(model, mesh=mesh, specs=specs, **opt_kw)
    model.train()

    it = (temporal_batch_iter(frames, args.queue_length, max_gt, dp, dp_rank) if args.temporal
          else batch_iter(frames, max_gt, dp, dp_rank))
    n_distinct = len(frames) // dp if not args.temporal else OVERFIT_BATCHES + 1
    if 0 < n_distinct <= OVERFIT_BATCHES:
        it = cached_iter([to_device(next(it), device) for _ in range(n_distinct)])
        print(f"cached {n_distinct} device-resident batches (overfit mode)", file=sys.stderr,
              flush=True)
    else:
        it = (to_device(b, device) for b in it)

    # the engine's deploy guard: a rig whose cameras see more BEV queries than
    # the compaction budget would truncate cross-attention in training too
    if cfg.cam_budget < 1.0 and lead:
        visible, overflow = cam_budget_overflow(cfg, np.asarray(frames.frame(0).lidar2img))
        if overflow > 0:
            print(f"WARNING: cam_budget={cfg.cam_budget} drops up to {overflow} visible BEV "
                  f"queries/camera on this rig (visible {visible.tolist()}); train with "
                  "cam_budget=1.0 for exact cross-attention", file=sys.stderr)

    step_fn = temporal_train_step if args.temporal else train_step
    history: List[Dict[str, float]] = []
    seconds: List[float] = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        t_step = time.perf_counter()
        metrics = step_fn(model, optimizer, next(it), mesh)
        history.append({k: float(metrics[k]) for k in SCALARS})
        seconds.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 and lead:
            m = history[-1]
            dt = time.perf_counter() - t0
            print(f"step {step}: loss {m['loss']:.4f} cls {m['loss_cls']:.4f} "
                  f"bbox {m['loss_bbox']:.4f} ({dt / (step + 1):.2f}s/step)", file=sys.stderr)
        if args.save_every and step and step % args.save_every == 0:
            save(cfg, model, args.out, mesh, specs)
    save(cfg, model, args.out, mesh, specs)
    if lead:
        print(f"saved -> {args.out}")
    if mesh is not None:
        dist.barrier()  # no rank leaves before rank 0 has written
        dist.destroy_process_group()
    return TrainResult(cfg, model, optimizer, history, seconds, args.out)


if __name__ == "__main__":
    main()
