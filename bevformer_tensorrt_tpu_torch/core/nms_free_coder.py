"""NMS-free box decoding for BEVFormer outputs
(port of `bevformer_tensorrt_tpu/core/nms_free_coder.py`): top-k over
query x class sigmoid scores, box denormalization (exp sizes, atan2 yaw),
post-center-range filter as a validity mask, ragged results on the host."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def denormalize_bbox(normalized):
    """[..., 10] (cx, cy, w, l, cz, h, rot_sin, rot_cos, vx, vy) ->
    [..., 9] (cx, cy, cz, w, l, h, yaw, vx, vy)."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    cx, cy, cz = normalized[..., 0:1], normalized[..., 1:2], normalized[..., 4:5]
    w = torch.exp(normalized[..., 2:3])
    l = torch.exp(normalized[..., 3:4])
    h = torch.exp(normalized[..., 5:6])
    return torch.cat([cx, cy, cz, w, l, h, rot, normalized[..., 8:10]], dim=-1)


@dataclasses.dataclass(frozen=True)
class NMSFreeCoder:
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    max_num: int = 300
    num_classes: int = 10
    score_threshold: float | None = None

    def decode_single(self, cls_scores, bbox_preds):
        """cls_scores [num_query, num_classes] logits; bbox_preds [num_query, 10].
        Returns (bboxes [K, 9], scores [K], labels [K], valid [K] bool),
        K = min(max_num, num_query * num_classes).  Ties in the score keep the
        lower index first, as `jax.lax.top_k` does."""
        scores = torch.sigmoid(cls_scores.float()).reshape(-1)
        k = min(self.max_num, scores.shape[0])
        top_scores, idx = torch.sort(scores, descending=True, stable=True)
        top_scores, idx = top_scores[:k], idx[:k]
        labels = idx % self.num_classes
        boxes = denormalize_bbox(bbox_preds[idx // self.num_classes].float())
        rng = torch.tensor(self.post_center_range, dtype=torch.float32, device=boxes.device)
        valid = (boxes[:, :3] >= rng[:3]).all(dim=1) & (boxes[:, :3] <= rng[3:]).all(dim=1)
        if self.score_threshold is not None:
            valid = valid & (top_scores > self.score_threshold)
        return boxes, top_scores, labels, valid

    def decode(self, outputs_classes, outputs_coords):
        """Decode the last decoder level for every sample in the batch into
        host-side ragged results (list of dicts of numpy arrays)."""
        cls, box = outputs_classes[-1], outputs_coords[-1]
        results = []
        for i in range(cls.shape[0]):
            boxes, scores, labels, valid = (t.cpu() for t in self.decode_single(cls[i], box[i]))
            results.append({
                "boxes_3d": boxes[valid].numpy(),
                "scores_3d": scores[valid].numpy(),
                "labels_3d": labels[valid].numpy(),
            })
        return results
