"""The 2D family's training criteria, YOLOX (SimOTA) and CenterNet (port of
`bevformer_tensorrt_tpu/train/losses2d.py`).

  * YOLOX: mmdet's SimOTAAssigner (centre-prior candidates, a cost of
    class BCE + 3 x IoU cost, a dynamic k from the top-10 IoU mass), then the
    IoU loss (squared, weight 5), the class BCE against IoU-soft targets and
    the objectness BCE [mmdet yolox_head.py loss_by_feat,
    sim_ota_assigner.py].
  * CenterNet: the gaussian focal heatmap loss (alpha 2, gamma 4, radius at
    overlap 0.3) and masked L1 on wh (weight 0.1) and the centre offset
    (weight 1) [mmdet centernet_head.py loss_by_feat].

One image at a time, with static shapes: GT arrives as `gt_boxes` [G, 4]
xyxy in input pixels and `gt_labels` [G] with -1 padding, and the masks stand
where the JAX package masks, so a step makes no host round trip.  The head
maps are NHWC, as the JAX package's; the caller transposes the port's NCHW
maps at the boundary (`tools/det2d/train.py::nhwc`).

What the assignment must keep of the JAX package's: a candidate that is not
strong costs 1e8 more, and at 1e8 float32's step is 8, so such candidates
tie and only the stable sort's prior order ranks them; the rank is the
sort's inverse permutation, and `argmin` keeps the first of equal costs.
The cost, its top-k and its sort run without gradient; the matched IoU
keeps its gradient into the soft class target and the IoU loss, as in JAX
(no stop_gradient there).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .losses_bevdet import gaussian_radius as _gaussian_radius

INF = 1e8


def _max0(x):
    """max(x, 0) with JAX's gradient at the tie (half to each side)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pairwise_iou(boxes1, boxes2):
    """[P, 4] x [G, 4] xyxy -> [P, G]."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = _max0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    a1 = _max0(boxes1[:, 2] - boxes1[:, 0]) * _max0(boxes1[:, 3] - boxes1[:, 1])
    a2 = _max0(boxes2[:, 2] - boxes2[:, 0]) * _max0(boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return inter / torch.maximum(union, torch.full((), 1e-9, device=union.device))


def _bce_logits(logits, targets):
    return _max0(logits) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def _flatten_yolox(outs: Sequence[Dict[str, torch.Tensor]], strides, img_idx: int):
    """One image's per-level NHWC maps -> flat per-prior (cls [P, C], reg
    [P, 4], obj [P], centres [P, 2], stride [P]), levels in order, each
    level's priors row-major."""
    cls_l, reg_l, obj_l, centers_l, stride_l = [], [], [], [], []
    for o, s in zip(outs, strides):
        _, h, w, C = o["cls"].shape
        dev = o["cls"].device
        gy, gx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        centers = (torch.stack([gx, gy], -1).reshape(-1, 2) + 0.5) * s
        cls_l.append(o["cls"][img_idx].reshape(-1, C))
        reg_l.append(o["reg"][img_idx].reshape(-1, 4))
        obj_l.append(o["obj"][img_idx].reshape(-1))
        centers_l.append(centers.to(torch.float32))
        stride_l.append(torch.full((h * w,), float(s), dtype=torch.float32, device=dev))
    return (torch.cat(cls_l), torch.cat(reg_l), torch.cat(obj_l), torch.cat(centers_l),
            torch.cat(stride_l))


def _decode_boxes(reg, centers, stride):
    """mmdet YOLOXHead._bbox_decode: xy = (pred + grid) * stride, written as
    the grid origin (centre - stride / 2) + pred * stride; wh = exp(pred) *
    stride, the exponent clipped to [-20, 8]."""
    xy = centers - 0.5 * stride[:, None] + reg[:, :2] * stride[:, None]
    wh = torch.exp(torch.clamp(reg[:, 2:], -20.0, 8.0)) * stride[:, None]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def simota_assign(cls, obj, iou, centers, stride, gt_boxes, gt_labels,
                  num_classes: int, candidate_topk: int = 10,
                  center_radius: float = 2.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """SimOTA over P priors and G GT rows, without gradient: (fg [P] bool,
    best_gt [P] int64), `losses2d.py:102-151` of the JAX package."""
    with torch.no_grad():
        P, G = cls.shape[0], gt_labels.shape[0]
        valid_gt = gt_labels >= 0
        # candidates: the prior's centre inside the GT box, or inside the
        # 2.5-stride box around the GT's centre
        cx, cy = centers[:, 0:1], centers[:, 1:2]
        in_gt = ((cx >= gt_boxes[:, 0][None]) & (cx <= gt_boxes[:, 2][None])
                 & (cy >= gt_boxes[:, 1][None]) & (cy <= gt_boxes[:, 3][None]))
        gcx = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
        gcy = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
        r = center_radius * stride[:, None]
        in_center = ((cx >= gcx[None] - r) & (cx <= gcx[None] + r)
                     & (cy >= gcy[None] - r) & (cy <= gcy[None] + r))
        cand = (in_gt | in_center) & valid_gt[None, :]
        strong = in_gt & in_center

        score = torch.sigmoid(cls) * torch.sigmoid(obj)[:, None]  # [P, C]
        onehot = F.one_hot(gt_labels.clamp_min(0).long(), num_classes).to(cls.dtype)  # [G, C]
        sq = torch.sqrt(torch.clamp(score, 1e-9, 1.0))
        # BCE(sqrt(score), onehot) summed over the classes, per (prior, GT)
        cls_cost = -(onehot[None] * torch.log(sq[:, None])
                     + (1 - onehot[None]) * torch.log1p(-torch.clamp(sq[:, None], 0, 1 - 1e-9))
                     ).sum(-1)  # [P, G]
        iou_cost = -torch.log(iou + 1e-8)
        cost = cls_cost + 3.0 * iou_cost + INF * (~strong).to(cls.dtype)
        cost = torch.where(cand, cost, torch.full_like(cost, INF * 2))

        # the dynamic k of each GT: its top-10 candidate IoUs summed,
        # truncated, at least 1
        iou_cand = torch.where(cand, iou, torch.zeros_like(iou))
        topk_iou = torch.topk(iou_cand.t(), min(candidate_topk, P), dim=1).values  # [G, k]
        dyn_k = topk_iou.sum(-1).to(torch.int32).clamp_min(1)

        # each GT keeps the priors whose rank by cost is below its k: the rank
        # is the inverse of the stable sort's permutation
        order = torch.argsort(cost, dim=0, stable=True)  # [P, G]
        ranks = torch.arange(P, device=cost.device)[:, None].expand(P, G)
        rank = torch.empty_like(order).scatter_(0, order, ranks)
        matched = (rank < dyn_k[None, :].long()) & cand

        # a prior matched to several GT keeps the cheapest (the first of equals)
        best_gt = torch.argmin(torch.where(matched, cost, torch.full_like(cost, INF * 4)), dim=1)
        fg = matched.gather(1, best_gt[:, None])[:, 0] & valid_gt[best_gt]
    return fg, best_gt


def yolox_loss_single(outs: Sequence[Dict[str, torch.Tensor]], gt_boxes, gt_labels,
                      num_classes: int, strides: Tuple[int, ...] = (8, 16, 32),
                      candidate_topk: int = 10, center_radius: float = 2.5, img_idx: int = 0,
                      assigned: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """SimOTA and the YOLOX losses of image `img_idx` of NHWC maps `outs`
    (per level {cls, reg, obj}).  Returns the JAX function's terms (loss_cls,
    loss_obj, loss_bbox, loss, num_pos) and the assignment (fg [P], best_gt
    [P]).  `assigned` replaces the assignment with a given (fg, best_gt):
    a step held to another device's assignment replays it."""
    cls, reg, obj, centers, stride = _flatten_yolox(outs, strides, img_idx)
    P = cls.shape[0]
    boxes = _decode_boxes(reg, centers, stride)  # [P, 4]
    iou = _pairwise_iou(boxes, gt_boxes)  # [P, G]
    if assigned is None:
        assigned = simota_assign(cls, obj, iou.detach(), centers, stride, gt_boxes,
                                 gt_labels, num_classes, candidate_topk, center_radius)
    fg, best_gt = assigned
    fgf = fg.to(cls.dtype)
    num_pos = torch.clamp_min(fg.sum(), 1).to(torch.float32)

    matched_iou = iou[torch.arange(P, device=iou.device), best_gt]
    cls_target = (F.one_hot(gt_labels[best_gt].clamp_min(0).long(), num_classes).to(cls.dtype)
                  * matched_iou[:, None])
    loss_cls = (_bce_logits(cls, cls_target).sum(-1) * fgf).sum() / num_pos
    loss_obj = _bce_logits(obj, fgf).sum() / num_pos
    # the IoU loss, squared (mmdet IoULoss(mode='square'), weight 5)
    loss_box = (5.0 * (1.0 - matched_iou ** 2) * fgf).sum() / num_pos
    return {"loss_cls": loss_cls, "loss_obj": loss_obj, "loss_bbox": loss_box,
            "loss": loss_cls + loss_obj + loss_box, "num_pos": num_pos,
            "fg": fg, "best_gt": best_gt}


def centernet_targets(gt_boxes, gt_labels, num_classes: int, feat_h: int, feat_w: int,
                      stride: int = 4):
    """The heatmap [H, W, C], centres [G, 2], their integer cells [G, 2]
    (int32), widths and heights [G] in map cells and the in-map mask [G] of
    mmdet CenterNetHead.get_targets.  The classes' heatmaps are the max over
    their GT's gaussians, taken by one scatter (no [G, C, H, W] tensor)."""
    G = gt_labels.shape[0]
    valid = gt_labels >= 0
    ctr = torch.stack([(gt_boxes[:, 0] + gt_boxes[:, 2]) / 2,
                       (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2], -1) / stride
    ctr_int = torch.floor(ctr).to(torch.int32)
    w = (gt_boxes[:, 2] - gt_boxes[:, 0]) / stride
    h = (gt_boxes[:, 3] - gt_boxes[:, 1]) / stride
    radius = torch.clamp_min(_gaussian_radius(h, w), 0.0)
    sigma = (2 * radius + 1) / 6.0

    dev = gt_boxes.device
    gx = torch.arange(feat_w, dtype=torch.float32, device=dev)
    gy = torch.arange(feat_h, dtype=torch.float32, device=dev)
    dx2 = (gx[None, None, :] - ctr_int[:, 0, None, None]) ** 2  # [G, 1, W]
    dy2 = (gy[None, :, None] - ctr_int[:, 1, None, None]) ** 2  # [G, H, 1]
    g = torch.exp(-(dx2 + dy2) / torch.clamp_min(2 * sigma[:, None, None] ** 2, 1e-6))
    # mmdet gen_gaussian_target truncates outside the radius box
    inside = ((torch.sqrt(dx2) <= radius[:, None, None] + 0.5)
              & (torch.sqrt(dy2) <= radius[:, None, None] + 0.5))
    g = (g * inside * valid[:, None, None]).reshape(G, feat_h * feat_w)
    labels = gt_labels.clamp_min(0).long()[:, None].expand(G, feat_h * feat_w)
    heat = torch.zeros((num_classes, feat_h * feat_w), dtype=g.dtype, device=dev)
    heat = heat.scatter_reduce(0, labels, g, "amax", include_self=True)

    in_bounds = (valid & (ctr_int[:, 0] >= 0) & (ctr_int[:, 0] < feat_w)
                 & (ctr_int[:, 1] >= 0) & (ctr_int[:, 1] < feat_h))
    return (heat.t().reshape(feat_h, feat_w, num_classes), ctr, ctr_int, w, h, in_bounds)


def centernet_loss_single(heads: Dict[str, torch.Tensor], gt_boxes, gt_labels,
                          num_classes: int, stride: int = 4,
                          img_idx: int = 0) -> Dict[str, torch.Tensor]:
    """The CenterNet losses of image `img_idx` of NHWC maps `heads`
    ({heatmap, wh, offset}): loss_heatmap, loss_wh, loss_offset, loss and
    num_pos (the GT whose centre lies on the map)."""
    hm_pred = heads["heatmap"][img_idx]  # [H, W, C] logits
    wh_pred = heads["wh"][img_idx]
    off_pred = heads["offset"][img_idx]
    H, W = hm_pred.shape[:2]
    heat, ctr, ctr_int, bw, bh, ok = centernet_targets(gt_boxes, gt_labels, num_classes, H, W,
                                                       stride)
    p = torch.sigmoid(hm_pred)
    eps = 1e-6
    pos = (heat >= 1.0 - 1e-6).to(p.dtype)
    # gaussian focal loss (alpha 2, gamma 4)
    loss_pos = -((1 - p) ** 2) * torch.log(p + eps) * pos
    loss_neg = -((1 - heat) ** 4) * (p ** 2) * torch.log(1 - p + eps) * (1 - pos)
    num_pos = torch.clamp_min(pos.sum(), 1.0)
    loss_heat = (loss_pos + loss_neg).sum() / num_pos

    # wh and offset L1 at the centre cells
    hi = torch.tensor([W - 1, H - 1], dtype=ctr_int.dtype, device=ctr_int.device)
    idx = torch.minimum(ctr_int.clamp_min(0), hi).long()
    wh_at = wh_pred[idx[:, 1], idx[:, 0]]      # [G, 2]
    off_at = off_pred[idx[:, 1], idx[:, 0]]    # [G, 2]
    okf = ok.to(torch.float32)
    n = torch.clamp_min(okf.sum(), 1.0)
    loss_wh = 0.1 * (torch.abs(wh_at - torch.stack([bw, bh], -1)) * okf[:, None]).sum() / (2 * n)
    loss_off = (torch.abs(off_at - (ctr - ctr_int)) * okf[:, None]).sum() / (2 * n)
    return {"loss_heatmap": loss_heat, "loss_wh": loss_wh, "loss_offset": loss_off,
            "loss": loss_heat + loss_wh + loss_off, "num_pos": okf.sum()}
