"""CenterPoint head for BEVDet: shared conv, separate branch heads, the box
decode and the Scale-NMS post-process (port of
`bevformer_tensorrt_tpu/models/heads/centerpoint_head.py`).

The reference's CenterHead (third_party/bev_mmdet3d/models/dense_heads/
centerpoint_head.py, the single-task 10-class variant of
configs/bevdet/bevdet-r50-cbgs.py: share_conv 64, heads reg 2 / height 1 /
dim 3 / rot 2 / vel 2 / heatmap 10) and CenterPointBBoxCoder (max_num 500,
score 0.1, out_size_factor 8).  The decode runs on the model's device; the
Scale-NMS on the host, with the native rotated NMS (`native.py`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...configs.bevdet import BEVDetConfig
from ...core.nms import scale_nms
from ...native import nms_rotated_native
from ..layers import FrozenBN, QConv

HEADS = (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))
HEATMAP_PRIOR = -2.19  # SeparateHead's init_bias on the heatmap conv


class SeparateBranch(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid_ch: int = 64, quant=False):
        super().__init__()
        self.conv1 = QConv(in_ch, mid_ch, 3, 1, 1, bias=False, quant=quant)
        self.bn1 = FrozenBN(mid_ch)
        self.conv2 = QConv(mid_ch, out_ch, 3, 1, 1, bias=True, quant=quant)

    def forward(self, x):
        return self.conv2(F.relu(self.bn1(self.conv1(x))))


class CenterHead(nn.Module):
    def __init__(self, cfg: BEVDetConfig, in_channels: int):
        super().__init__()
        sc = cfg.share_conv_channel
        self.shared_conv = QConv(in_channels, sc, 3, 1, 1, bias=False, quant=cfg.quant)
        self.shared_bn = FrozenBN(sc)
        self.head_names = [n for n, _ in HEADS] + ["heatmap"]
        for name, ch in HEADS + (("heatmap", cfg.num_classes),):
            setattr(self, name, SeparateBranch(sc, ch, mid_ch=sc, quant=cfg.quant))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: [1, C, bev_h, bev_w] -> the head maps, NCHW."""
        x = F.relu(self.shared_bn(self.shared_conv(x)))
        return {name: getattr(self, name)(x) for name in self.head_names}


def centerpoint_decode(cfg: BEVDetConfig, heads: Dict[str, torch.Tensor]):
    """CenterPointBBoxCoder.decode on NCHW head maps: the top `max_num` of
    the sigmoid heatmap, class-major, the regressions gathered there, boxes
    in the lidar frame.  Returns (boxes [K, 9] (x, y, z, w, l, h, yaw, vx,
    vy), scores [K], labels [K], valid [K]) on the maps' device.  Ties in
    score keep the lower flat index first (a stable sort), as
    `jax.lax.top_k` does."""
    _, _, H, W = heads["heatmap"].shape
    K = cfg.max_num
    heat = torch.sigmoid(heads["heatmap"][0].float())  # [C, H, W], class-major
    scores_sorted, order = torch.sort(heat.reshape(-1), descending=True, stable=True)
    top_scores, idx = scores_sorted[:K], order[:K]
    labels = idx // (H * W)
    spatial = idx % (H * W)
    ys = (spatial // W).float()
    xs = (spatial % W).float()

    def gather(name):
        v = heads[name][0].float()
        return v.reshape(v.shape[0], H * W)[:, spatial].T  # [K, ch]

    reg = gather("reg")
    height = gather("height")
    dim = torch.exp(gather("dim"))  # norm_bbox: log-space sizes
    rot = gather("rot")
    vel = gather("vel")
    xs = (xs + reg[:, 0]) * cfg.out_size_factor * cfg.voxel_size[0] + cfg.pc_range[0]
    ys = (ys + reg[:, 1]) * cfg.out_size_factor * cfg.voxel_size[1] + cfg.pc_range[1]
    yaw = torch.atan2(rot[:, 0], rot[:, 1])
    boxes = torch.cat([xs[:, None], ys[:, None], height, dim, yaw[:, None], vel], dim=-1)
    rng = torch.tensor(cfg.post_center_range, dtype=torch.float32, device=boxes.device)
    valid = ((boxes[:, :3] >= rng[:3]).all(1) & (boxes[:, :3] <= rng[3:]).all(1)
             & (top_scores > cfg.score_threshold))
    return boxes, top_scores, labels, valid


def centerpoint_post_process(cfg: BEVDetConfig, boxes, scores, labels, valid,
                             nms=True) -> Dict[str, np.ndarray]:
    """Host side: the valid decoded boxes (host tensors or arrays from
    `centerpoint_decode`), then Scale-NMS through the native rotated NMS
    (`core.nms.nms_rotated` is the tests' oracle)."""
    v = np.asarray(valid).astype(bool)
    b = np.asarray(boxes, np.float32)[v]
    s = np.asarray(scores, np.float32)[v]
    lab = np.asarray(labels).astype(np.int64)[v]
    if nms and len(b):
        keep = scale_nms(b, s, lab, iou_threshold=cfg.nms_thr,
                         rescale_factors=cfg.nms_rescale_factor, nms=nms_rotated_native)
        b, s, lab = b[keep], s[keep], lab[keep]
    return {"boxes_3d": b, "scores_3d": s, "labels_3d": lab}
