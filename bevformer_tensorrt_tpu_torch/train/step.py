"""BEVFormer training step: DETR loss over the decoder levels, the AdamW
recipe, the single-frame and temporal-queue steps
(port of `bevformer_tensorrt_tpu/train/step.py`).

The reference's train loop body: Hungarian matching per decoder level, focal
classification loss (weight 2.0) and L1 box loss (weight 0.25, velocities
down-weighted 5x), normalized by the positive count; AdamW with cosine decay,
linear warmup, a global-norm clip of 35 and 0.1x the update on the image
backbone.

The port's model takes one sample (bs = 1), so the B samples of a batch run
one after another.  Every cost matrix of the step goes to the host in one
copy (`assigner.assign_levels`).  BatchNorm statistics are frozen buffers;
FrozenBN's weight and bias train, as flax's `scale` and `bias` do.

Batch dict (leading dim B), tensors on the model's device:
  image      [B, cams, 3, H, W]        (temporal: [B, T, cams, 3, H, W])
  can_bus    [B, 18]                   ([B, T, 18], relative deltas)
  lidar2img  [B, 1, cams, 4, 4]        ([B, T, 1, cams, 4, 4])
  gt_boxes   [B, max_gt, 9]            (the last frame's)
  gt_labels  [B, max_gt] int, -1 = padding

Quantization-aware training (the JAX steps' `quant_vars`) is a model built
with `quant=True` whose QDQ sites hold their calibrated scales
(`quant.fold.attach_quant_scales`): activations are fake-quantized with
those fixed scales (buffers, which the optimizer never sees), weights per
output channel from the live weight, and gradients pass by the
straight-through rule.  `check_quant_scales` refuses a quantized model with a
live site that has no scale, where "QAT" would silently train floating point;
a step runs it on an optimizer's first step (the scales are fixed after).

Data parallelism (`mesh` with a dp axis; `parallel/`): each dp rank takes
its share of the global batch, the positive count is summed over dp before
it divides (the reference's `sync_cls_avg_factor`), and the gradients are
summed over dp in one all-reduce, so a dp step is the one-process step on
the global batch.  Under tensor parallelism (`parallel.shard_parameters`)
the optimizer's global norm counts each shard once and each replicated
parameter once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..configs.bevformer import BEVFormerConfig
from ..models.detectors.bevformer import BEVFormer
from ..parallel import comm
from ..quant.calibrate import qdq_sites
from ..weights import init_weights
from .assigner import assign_levels
from .losses import bbox_l1_cost, focal_cls_cost, l1_loss, normalize_bbox, sigmoid_focal_loss

CLS_WEIGHT = 2.0
BBOX_WEIGHT = 0.25
# the reference's code_weights (bevformer_head.py:71,427): velocities 0.2
CODE_WEIGHTS = (1.0,) * 8 + (0.2,) * 2


def match_costs(outputs_classes, outputs_coords, gt_code, gt_labels):
    """The matching cost of every decoder level, [L, max_gt, nq]: focal
    class cost plus box L1 cost, padded GT rows set to 0 (constant).  No
    gradient flows through the matching."""
    with torch.no_grad():
        cls = outputs_classes[:, 0]  # [L, nq, classes]
        c_cls = focal_cls_cost(cls, gt_labels, weight=CLS_WEIGHT)            # [L, nq, G]
        c_reg = bbox_l1_cost(outputs_coords[:, 0], gt_code, weight=BBOX_WEIGHT)
        cost = (c_cls + c_reg).transpose(1, 2)                               # [L, G, nq]
        return torch.where((gt_labels >= 0)[None, :, None], cost, torch.zeros_like(cost))


def detr_loss_assigned(outputs_classes, outputs_coords, gt_code, gt_labels, row2col,
                       num_classes: int) -> Dict[str, torch.Tensor]:
    """The loss of every level given its assignment row2col [L, max_gt]:
    matched GT scattered onto the queries, focal loss over all queries, L1
    over the matched ones whose target is finite.  Returns the sums over the
    levels and num_pos = valid GT x L (the caller normalizes)."""
    L, _, nq, _ = outputs_classes.shape
    G = gt_labels.shape[0]
    cls, coords = outputs_classes[:, 0], outputs_coords[:, 0]
    valid = gt_labels >= 0
    q_idx = torch.where(valid, row2col, torch.full_like(row2col, nq))  # padding -> overflow slot
    lab = torch.where(valid, gt_labels.long(), torch.full_like(gt_labels.long(), num_classes))
    labels = torch.full((L, nq + 1), num_classes, dtype=torch.long, device=cls.device)
    labels = labels.scatter(1, q_idx, lab.expand(L, G))[:, :nq]
    code = torch.where(valid[:, None], gt_code, torch.zeros_like(gt_code)).to(coords.dtype)
    targets = torch.zeros((L, nq + 1, code.shape[-1]), dtype=coords.dtype, device=coords.device)
    targets = targets.scatter(1, q_idx[..., None].expand(L, G, code.shape[-1]),
                              code.expand(L, G, -1))[:, :nq]
    pos = torch.zeros((L, nq + 1), dtype=torch.bool, device=cls.device)
    pos = pos.scatter(1, q_idx, valid.expand(L, G))[:, :nq]

    cls_sum = sigmoid_focal_loss(cls, labels, num_classes).sum() * CLS_WEIGHT
    code_ok = torch.isfinite(targets).all(-1) & pos
    code_w = torch.tensor(CODE_WEIGHTS, dtype=coords.dtype, device=coords.device)
    bbox_sum = ((l1_loss(coords, targets) * code_w).sum(-1)
                * code_ok.to(coords.dtype)).sum() * BBOX_WEIGHT
    return {"cls_sum": cls_sum, "bbox_sum": bbox_sum,
            "num_pos": valid.sum().to(torch.float32) * L}


def bevformer_detr_loss(outputs_classes, outputs_coords, gt_boxes, gt_labels,
                        num_classes: int) -> Dict[str, torch.Tensor]:
    """One sample's loss over every decoder level: outputs_classes
    [L, 1, nq, classes], outputs_coords [L, 1, nq, 10], gt_boxes [max_gt, 9],
    gt_labels [max_gt].  Unnormalized sums and num_pos, as the JAX function."""
    gt_code = normalize_bbox(gt_boxes)
    costs = match_costs(outputs_classes, outputs_coords, gt_code, gt_labels)
    row2col = assign_levels(costs[None], (gt_labels >= 0)[None])[0]
    return detr_loss_assigned(outputs_classes, outputs_coords, gt_code, gt_labels, row2col,
                              num_classes)


def _normalized_loss(outputs, batch, num_classes: int, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """The samples' DETR losses from their (classes, coords), matched in one
    host round trip, summed and divided by max(sum of num_pos, 1), the sum
    taken over the dp ranks' samples under `mesh`.  The metrics are the
    global batch's."""
    gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
    codes = [normalize_bbox(gt_boxes[b]) for b in range(len(outputs))]
    costs = torch.stack([match_costs(c, o, codes[b], gt_labels[b])
                         for b, (c, o) in enumerate(outputs)])
    row2col = assign_levels(costs, gt_labels >= 0)
    parts = [detr_loss_assigned(c, o, codes[b], gt_labels[b], row2col[b], num_classes)
             for b, (c, o) in enumerate(outputs)]
    num_pos = sum(p["num_pos"] for p in parts)
    if mesh is not None:
        num_pos = comm.all_reduce(num_pos.detach().clone(), mesh, "dp")
    num_pos = torch.clamp_min(num_pos, 1.0)
    cls = sum(p["cls_sum"] for p in parts) / num_pos
    bbox = sum(p["bbox_sum"] for p in parts) / num_pos
    loss = cls + bbox
    parts = torch.stack([cls.detach(), bbox.detach()])
    if mesh is not None:
        parts = comm.all_reduce(parts, mesh, "dp")
    return loss, {"loss": parts.sum(), "loss_cls": parts[0], "loss_bbox": parts[1],
                  "num_pos": num_pos, "row2col": row2col}


def _zero_bev(model: BEVFormer, device) -> torch.Tensor:
    cfg = model.cfg
    return torch.zeros((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), dtype=torch.float32,
                       device=device)


def loss_fn(model: BEVFormer, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Single-frame loss (use_prev_bev 0, zero prev_bev), with its metrics."""
    image = batch["image"]
    outputs = []
    for b in range(image.shape[0]):
        _, classes, coords = model(image[b:b + 1], _zero_bev(model, image.device), 0.0,
                                   batch["can_bus"][b], batch["lidar2img"][b])
        outputs.append((classes, coords))
    return _normalized_loss(outputs, batch, model.cfg.num_classes, mesh)


def temporal_loss_fn(model: BEVFormer, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Temporal-queue loss (the reference's forward_train with
    obtain_history_bev): the first T-1 frames of each clip run without
    gradients to build prev_bev (use_prev_bev 0, then 1); the last frame
    trains against it."""
    image = batch["image"]
    T = image.shape[1]
    outputs = []
    for b in range(image.shape[0]):
        prev_bev, use_prev = _zero_bev(model, image.device), 0.0
        with torch.no_grad():
            for t in range(T - 1):
                prev_bev, _, _ = model(image[b, t][None], prev_bev, use_prev,
                                       batch["can_bus"][b, t], batch["lidar2img"][b, t])
                use_prev = 1.0
        _, classes, coords = model(image[b, T - 1][None], prev_bev, use_prev,
                                   batch["can_bus"][b, T - 1], batch["lidar2img"][b, T - 1])
        outputs.append((classes, coords))
    return _normalized_loss(outputs, batch, model.cfg.num_classes, mesh)


def warmup_cosine(count: int, peak: float, warmup: int, total: int,
                  end_fraction: float = 1e-3) -> float:
    """optax's warmup_cosine_decay_schedule(0, peak, warmup, total,
    end=peak * end_fraction) at step `count`: linear from 0 over `warmup`
    steps, then a cosine down to the end value at `total`.  BEVFormer's
    recipe ends at 1e-3 of the peak; optax's default (BEVDet's) at 0."""
    if count < warmup:
        return peak * count / warmup
    alpha = end_fraction
    decay = total - warmup
    t = min(count - warmup, decay)
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)


class Optimizer:
    """The reference's optimizer (configs/bevformer/bevformer_base.py),
    the JAX package's `make_optimizer` chain in order:
    - the gradients clipped by their global norm: g * clip / |g| where
      |g| >= clip (optax's `clip_by_global_norm`);
    - AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight
      decay on every parameter): p -= lr * (m_hat / (sqrt(v_hat) + eps) +
      wd * p), the rate from the schedule at the step count before it
      moves, so the first step's rate is 0 under a warmup;
    - parameters named `img_backbone.*` take `backbone_lr_mult` x the whole
      update (BEVDet's recipe passes 1.0: one rate for every parameter).
    A parameter that got no gradient is updated as with a zero gradient.
    With `mesh` and the specs of `parallel.shard_parameters`, the global
    norm sums the tp-sharded parameters' squares over tp (each shard once)
    and takes the replicated ones as they are (each once).
    Without `total_steps` the rate is constant.  The update is written out
    with in-place foreach ops rather than taken from `torch.optim`: it moves
    every parameter's version, on which `DeformConv2d` keys its kept weight
    matrix (fused AdamW does not), and it imports no `torch._dynamo`."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, model: nn.Module, learning_rate: float = 2e-4,
                 weight_decay: float = 0.01, backbone_lr_mult: float = 0.1,
                 total_steps: Optional[int] = None, warmup_steps: int = 500,
                 grad_clip: float = 35.0, end_fraction: float = 1e-3, mesh=None, specs=None):
        head, backbone = [], []
        for name, p in model.named_parameters():
            (backbone if "img_backbone" in name.split(".") else head).append(p)
        self.groups = [(g, mult) for g, mult in ((head, 1.0), (backbone, backbone_lr_mult)) if g]
        self.params = head + backbone
        self.mesh = mesh
        names = {id(p): n for n, p in model.named_parameters()}
        self.sharded = [any((specs or {}).get(names[id(p)], ())) for p in self.params]
        self.peak, self.warmup, self.grad_clip = learning_rate, warmup_steps, grad_clip
        self.weight_decay = weight_decay
        self.end_fraction = end_fraction
        self.total = None if total_steps is None else max(total_steps, warmup_steps + 1)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self, count: int) -> float:
        if self.total is None:
            return self.peak
        return warmup_cosine(count, self.peak, self.warmup, self.total, self.end_fraction)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        if any(self.sharded):
            mask = torch.tensor(self.sharded, device=norms.device)
            sq = (norms ** 2 * mask).sum()
            sq = comm.all_reduce(sq, self.mesh, "tp")
            norm = torch.sqrt(sq + (norms ** 2 * ~mask).sum())
        else:
            norm = torch.linalg.vector_norm(norms)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        torch._foreach_lerp_(self.mu, grads, 1 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1 - self.B2)
        t = self.count + 1
        denom = torch._foreach_sqrt(self.nu)  # sqrt(v_hat) + eps
        torch._foreach_div_(denom, math.sqrt(1 - self.B2 ** t))
        torch._foreach_add_(denom, self.EPS)
        lr, start = self.lr(self.count), 0
        for group, mult in self.groups:
            n, rate = len(group), lr * mult
            torch._foreach_mul_(group, 1 - rate * self.weight_decay)
            torch._foreach_addcdiv_(group, self.mu[start:start + n], denom[start:start + n],
                                    -rate / (1 - self.B1 ** t))
            start += n
        self.count = t


def check_quant_scales(model: nn.Module) -> None:
    """For a model built with `quant`, raise unless every live QDQ site
    (one the policy did not switch off) holds a scale: a site without one is
    the identity, and the step would train floating point there."""
    if not getattr(model.cfg, "quant", False):
        return
    missing = [name for name, site in qdq_sites(model).items() if site.scale is None]
    if missing:
        raise ValueError(
            f"quantization-aware training: {len(missing)} live QDQ sites have no scale "
            f"(first: {missing[0]}); attach calibrated scales with "
            "quant.fold.attach_quant_scales, or exclude the sites in the policy")


def sum_gradients(params, mesh, axis: str = "dp") -> None:
    """Sum the parameters' gradients over the axis in one all-reduce (a
    parameter without one contributes zeros)."""
    if mesh is None or mesh.group(axis) is None:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def _step(fn, model: BEVFormer, optimizer: Optimizer, batch, mesh=None) -> Dict:
    if optimizer.count == 0:
        check_quant_scales(model)
    optimizer.zero_grad()
    loss, metrics = fn(model, batch, mesh)
    loss.backward()
    sum_gradients(optimizer.params, mesh)
    optimizer.step()
    return metrics


def train_step(model: BEVFormer, optimizer: Optimizer, batch, mesh=None) -> Dict:
    """One single-frame step: loss, backward, update (QAT for a model built
    with `quant=True`, which `check_quant_scales` checks on the first step).  Returns the metrics
    as device tensors: loss, loss_cls, loss_bbox, num_pos and the matching
    row2col [B, levels, max_gt].  Under `mesh`, `batch` is this rank's dp
    share and the metrics are the global batch's."""
    return _step(loss_fn, model, optimizer, batch, mesh)


def temporal_train_step(model: BEVFormer, optimizer: Optimizer, batch, mesh=None) -> Dict:
    """One temporal-queue step (`temporal_loss_fn`), backward, update."""
    return _step(temporal_loss_fn, model, optimizer, batch, mesh)


def init_train_state(cfg: BEVFormerConfig, device, seed: int = 0,
                     **optimizer_kwargs) -> Tuple[BEVFormer, Optimizer]:
    """The model with the port's seeded `init_weights` on `device`, and its
    optimizer."""
    model = init_weights(BEVFormer(cfg), torch.Generator().manual_seed(seed)).to(device)
    return model, Optimizer(model, **optimizer_kwargs)
