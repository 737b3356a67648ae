"""DETR-style 3D detection losses and match costs
(port of `bevformer_tensorrt_tpu/train/losses.py`).

The reference's training criterion: `normalize_bbox`, mmdet's sigmoid
focal loss (gamma 2, alpha 0.25, weight 2.0) and L1 loss (weight 0.25) as
configured in configs/bevformer/bevformer_base.py, and the
HungarianAssigner3D match costs FocalLossCost(2.0) / BBox3DL1Cost(0.25).
Ground truth comes padded to a fixed `max_gt` with label -1 marking padding.
"""
from __future__ import annotations

import torch


def normalize_bbox(gt_boxes: torch.Tensor) -> torch.Tensor:
    """LiDAR 9-dof boxes [..., 9] (cx, cy, cz, w, l, h, rot, vx, vy), metric
    -> the 10-dim regression code [..., 10]
    (cx, cy, log w, log l, cz, log h, sin rot, cos rot, vx, vy), the order
    the head's regression branch decodes."""
    cx, cy, cz, w, l, h, rot, vx, vy = gt_boxes.split(1, dim=-1)
    eps = 1e-5
    return torch.cat([cx, cy, w.clamp_min(eps).log(), l.clamp_min(eps).log(), cz,
                      h.clamp_min(eps).log(), rot.sin(), rot.cos(), vx, vy], dim=-1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """Inverse of `normalize_bbox`: [..., 10] -> (cx, cy, cz, w, l, h, rot, vx, vy)."""
    cx, cy, lw, ll, cz, lh, s, c, vx, vy = code.split(1, dim=-1)
    return torch.cat([cx, cy, cz, lw.exp(), ll.exp(), lh.exp(), torch.atan2(s, c), vx, vy],
                     dim=-1)


def sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy from logits (the JAX
    package's `optax_sigmoid_ce`)."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-prediction focal loss [...], summed over classes, not normalized.
    `labels == num_classes` is background (an all-zero one-hot), mmdet's
    sigmoid FocalLoss of the reference config."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels[..., None].long() == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, onehot)
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    return (alpha_t * (1.0 - p_t).pow(gamma) * ce).sum(-1)


def focal_cls_cost(logits: torch.Tensor, gt_labels: torch.Tensor, alpha: float = 0.25,
                   gamma: float = 2.0, weight: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost: cost [..., nq, max_gt] of assigning query q to
    gt g, from logits [..., nq, num_classes] and gt_labels [max_gt] (padding
    entries arbitrary: the caller masks their rows)."""
    p = torch.sigmoid(logits)
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p.pow(gamma)
    pos = -torch.log(p + eps) * alpha * (1.0 - p).pow(gamma)
    labels = gt_labels.long().clamp(0, logits.shape[-1] - 1)
    return (pos - neg)[..., labels] * weight


def bbox_l1_cost(pred: torch.Tensor, gt_norm: torch.Tensor, weight: float = 0.25) -> torch.Tensor:
    """BBox3DL1Cost over the first 8 code dims (the reference assigner
    leaves the velocities out of the matching): pred [..., nq, 10] and
    gt_norm [max_gt, 10] -> [..., nq, max_gt]."""
    return (pred[..., None, :8] - gt_norm[None, :, :8]).abs().sum(-1) * weight


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise L1; the caller weights and normalizes."""
    return (pred - target).abs()
