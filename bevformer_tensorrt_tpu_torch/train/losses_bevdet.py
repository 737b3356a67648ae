"""BEVDet (CenterPoint head) training criterion (port of
`bevformer_tensorrt_tpu/train/losses_bevdet.py`).

The reference's mmdet3d CenterHead loss for BEVDet (gaussian-focal heatmap
plus code-weighted L1 at the GT centres) on the single-task head of
`models/heads/centerpoint_head.py` (reg / height / dim / rot / vel /
heatmap over one 10-class group, the bevdet-r50-cbgs layout).  GT arrives
padded to a fixed count with label -1; the gaussians of all GT are drawn at
once, with no loop over boxes.  The head maps are NCHW with batch 1, as the
port's `BEVDet` returns them.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# bevdet-r50-cbgs.py code_weights: vx / vy down-weighted 0.2
CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
LOSS_BBOX_WEIGHT = 0.25   # bevdet-r50-cbgs loss_bbox weight
GAUSSIAN_OVERLAP = 0.1    # train_cfg gaussian_overlap
MIN_RADIUS = 2            # train_cfg min_radius
REGRESSION_HEADS = ("reg", "height", "dim", "rot", "vel")


def gaussian_radius(h, w, min_overlap: float = 0.3):
    """mmdet's gaussian_radius: the least of the three quadratic cases."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def bevdet_targets(cfg, gt_boxes: torch.Tensor, gt_labels: torch.Tensor):
    """One sample's CenterPoint targets on the BEV grid.

    Args:
      gt_boxes: [G, 9] (cx, cy, cz, w, l, h, yaw, vx, vy), lidar frame;
        padded rows arbitrary.
      gt_labels: [G] integer, -1 = padding.
    Returns:
      heatmap [H, W, C] gaussian targets, anno [G, 10] regression targets
      (reg 2, height 1, log-dims 3, sin/cos 2, velocity 2), pos [G] the
      flattened centre index into H * W, mask [G] valid and on the grid.
    """
    H, W, C = cfg.bev_h, cfg.bev_w, cfg.num_classes
    boxes = gt_boxes.float()
    valid = gt_labels >= 0
    fx, fy = cfg.grid_xbound[2], cfg.grid_ybound[2]
    cx = (boxes[:, 0] - cfg.grid_xbound[0]) / fx
    cy = (boxes[:, 1] - cfg.grid_ybound[0]) / fy
    # floor, then cast: truncation would move negative centres onto the grid
    cxi = torch.floor(cx).to(torch.int64)
    cyi = torch.floor(cy).to(torch.int64)

    radius = torch.clamp(gaussian_radius(boxes[:, 4] / fy, boxes[:, 3] / fx,
                                         min_overlap=GAUSSIAN_OVERLAP), min=float(MIN_RADIUS))
    sigma = (2 * radius + 1) / 6.0
    gx = torch.arange(W, dtype=torch.float32, device=boxes.device)
    gy = torch.arange(H, dtype=torch.float32, device=boxes.device)
    dx2 = (gx[None, None, :] - cxi[:, None, None].float()) ** 2
    dy2 = (gy[None, :, None] - cyi[:, None, None].float()) ** 2
    g = torch.exp(-(dx2 + dy2) / torch.clamp(2 * sigma[:, None, None] ** 2, min=1e-6))
    r = radius[:, None, None] + 0.5
    inside = (torch.sqrt(dx2) <= r) & (torch.sqrt(dy2) <= r)
    in_bounds = valid & (cxi >= 0) & (cxi < W) & (cyi >= 0) & (cyi < H)
    g = g * inside * in_bounds[:, None, None]
    onehot = F.one_hot(gt_labels.clamp(min=0).long(), C).float()        # [G, C]
    heat = torch.amax(g[:, None] * onehot[:, :, None, None], dim=0)       # [C, H, W]

    anno = torch.cat([
        (cx - cxi)[:, None],
        (cy - cyi)[:, None],
        boxes[:, 2:3],                                  # z (gravity centre)
        torch.log(torch.clamp(boxes[:, 3:6], min=1e-3)),  # log dims (w, l, h)
        torch.sin(boxes[:, 6:7]),
        torch.cos(boxes[:, 6:7]),
        boxes[:, 7:9],                                  # vx, vy
    ], dim=-1)
    pos = cyi.clamp(0, H - 1) * W + cxi.clamp(0, W - 1)
    return heat.permute(1, 2, 0), anno, pos, in_bounds


def bevdet_loss_single(cfg, heads: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                       gt_labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gaussian-focal heatmap loss plus code-weighted L1 (mmdet3d
    CenterHead.loss) of one sample's head maps ([1, c, H, W] each)."""
    heat_t, anno, pos, mask = bevdet_targets(cfg, gt_boxes, gt_labels)
    Hm, Wm = heat_t.shape[:2]
    p = torch.sigmoid(heads["heatmap"][0].float().permute(1, 2, 0))       # [H, W, C]
    eps = 1e-6
    is_pos = (heat_t >= 1.0 - 1e-6).to(p.dtype)
    loss_pos = -((1 - p) ** 2) * torch.log(p + eps) * is_pos
    loss_neg = -((1 - heat_t) ** 4) * (p ** 2) * torch.log(1 - p + eps) * (1 - is_pos)
    num_pos = torch.clamp(is_pos.sum(), min=1.0)
    loss_heatmap = (loss_pos.sum() + loss_neg.sum()) / num_pos

    pred = torch.cat([heads[k][0].float().permute(1, 2, 0).reshape(Hm * Wm, -1)
                      for k in REGRESSION_HEADS], dim=-1)                  # [H * W, 10]
    cw = torch.tensor(CODE_WEIGHTS, dtype=torch.float32, device=pred.device)
    l1 = (pred[pos] - anno).abs() * cw[None, :] * mask[:, None]
    loss_bbox = LOSS_BBOX_WEIGHT * l1.sum() / torch.clamp(mask.sum() * 1.0, min=1.0)
    return {"loss_heatmap": loss_heatmap, "loss_bbox": loss_bbox,
            "loss": loss_heatmap + loss_bbox, "num_pos": mask.sum().float()}
