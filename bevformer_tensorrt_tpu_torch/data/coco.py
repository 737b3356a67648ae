"""COCO-format 2D detection set: its evaluation and training views (port of
`bevformer_tensorrt_tpu/data/coco.py`).

Parses an instances_*.json directly (no pycocotools), maps the sparse
category ids to contiguous labels, and serves each image letterboxed (a
nearest keep-ratio resize padded with 114 to a square, the YOLOX eval
pipeline), normalized, CHW: `sample` with its annotations as xyxy in the
original image's pixels, `train_sample` (after the optional augmentation of
`data/transforms2d.py`) with them in the model input's pixels.  Images are
read by the port's own `data.nuscenes.load_image` (BGR, as mmcv reads them).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .nuscenes import load_image


@dataclasses.dataclass
class CocoSample:
    image_id: str
    image: np.ndarray       # [3, H, W] float32 (normalized, padded)
    scale: float            # model input / original
    orig_hw: Tuple[int, int]
    gt: List[dict]          # [{image_id, category_id (contiguous), bbox xyxy}]


class CocoDataset:
    def __init__(self, ann_file, img_root, img_size: int = 640, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), to_rgb: bool = False):
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.img_root = Path(img_root)
        self.img_size = img_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        cats = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_to_label = {c: i for i, c in enumerate(cats)}
        self.anns: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            self.anns.setdefault(a["image_id"], []).append(a)
        self.ids = [im["id"] for im in coco["images"]]

    def __len__(self) -> int:
        return len(self.ids)

    def _image(self, i: int) -> np.ndarray:
        return load_image(str(self.img_root / self.images[self.ids[i]]["file_name"]))

    def raw(self, i: int):
        """(float32 BGR HWC image, xyxy boxes [N, 4] float32, labels [N]
        int32) in the original image's pixels."""
        boxes, labels = [], []
        for a in self.anns.get(self.ids[i], []):
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_to_label[a["category_id"]])
        return (self._image(i).astype(np.float32), np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32).reshape(-1))

    def _letterbox(self, img: np.ndarray):
        """Nearest keep-ratio resize padded with 114 to a square.  Returns
        (canvas HWC float32 raw BGR, scale)."""
        h, w = img.shape[:2]
        scale = min(self.img_size / h, self.img_size / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        ys = (np.arange(nh) / scale).astype(np.int64).clip(0, h - 1)
        xs = (np.arange(nw) / scale).astype(np.int64).clip(0, w - 1)
        canvas = np.full((self.img_size, self.img_size, 3), 114.0, np.float32)
        canvas[:nh, :nw] = img[ys][:, xs]
        return canvas, scale

    def _normalize(self, canvas: np.ndarray) -> np.ndarray:
        if self.to_rgb:
            canvas = canvas[..., ::-1]
        canvas = (canvas - self.mean) / self.std
        return canvas.transpose(2, 0, 1).astype(np.float32)

    def train_sample(self, i: int, augment=None):
        """The training view: (normalized letterboxed image, xyxy boxes,
        labels) with the GT in the model input's pixels, where the loss's
        grid priors are: scaled by the letterbox, clipped to the square, the
        boxes of 1 px or less dropped.  `augment` is a
        `transforms2d.YoloxTrainAugment` or None."""
        if augment is not None:
            img, boxes, labels = augment(i, len(self), self.raw)
        else:
            img, boxes, labels = self.raw(i)
        canvas, scale = self._letterbox(img)
        boxes = boxes * scale
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, self.img_size)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, self.img_size)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 1) & ((boxes[:, 3] - boxes[:, 1]) > 1)
        return self._normalize(canvas), boxes[keep], labels[keep]

    def sample(self, i: int) -> CocoSample:
        img = self._image(i)
        h, w = img.shape[:2]
        canvas, scale = self._letterbox(img.astype(np.float32))
        gts = []
        for a in self.anns.get(self.ids[i], []):
            x, y, bw, bh = a["bbox"]
            gts.append({"image_id": str(self.ids[i]),
                        "category_id": self.cat_to_label[a["category_id"]],
                        "bbox": [x, y, x + bw, y + bh]})
        return CocoSample(image_id=str(self.ids[i]), image=self._normalize(canvas), scale=scale,
                          orig_hw=(h, w), gt=gts)
