"""The YOLOX train augmentation in numpy, on the host (port of
`bevformer_tensorrt_tpu/data/transforms2d.py`).

The reference's mmdet pipeline for the 2D family
(configs/yolox/yolox_x_8x8_300e_coco.py:33-52): Mosaic -> RandomAffine ->
MixUp -> YOLOXHSVRandomAug -> RandomFlip.  Every transform works on raw
float32 BGR images in [0, 255] with xyxy boxes and int32 labels, and draws
from one explicit `np.random.Generator` in the JAX package's order, so one
seed gives the same arrays bit for bit; letterboxing and normalization come
after, in `data/coco.py::CocoDataset.train_sample`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .transforms import bgr2hsv, hsv2bgr

Boxes = np.ndarray  # [N, 4] xyxy float32
Labels = np.ndarray  # [N] int32


def _affine_warp(img: np.ndarray, mat: np.ndarray, out_h: int, out_w: int,
                 pad_val: float) -> np.ndarray:
    """Nearest-neighbour warp of [H, W, 3] by the 3x3 forward matrix `mat`
    (output = mat @ input coordinates), sampled backwards as
    cv2.warpPerspective does."""
    inv = np.linalg.inv(mat)
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    pts = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1).astype(np.float64)
    src = inv @ pts
    sx = np.round(src[0] / src[2]).astype(np.int64)
    sy = np.round(src[1] / src[2]).astype(np.int64)
    valid = (sx >= 0) & (sx < img.shape[1]) & (sy >= 0) & (sy < img.shape[0])
    out = np.full((out_h * out_w, 3), pad_val, np.float32)
    out[valid] = img[sy[valid], sx[valid]]
    return out.reshape(out_h, out_w, 3)


def _transform_boxes(boxes: Boxes, mat: np.ndarray) -> Boxes:
    """xyxy boxes through a 3x3 matrix: the four corners mapped, re-boxed."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    x1, y1, x2, y2 = boxes.T
    corners = np.stack([np.stack([x1, y1]), np.stack([x2, y1]), np.stack([x1, y2]),
                        np.stack([x2, y2])], axis=0)  # [4, 2, N]
    pts = np.concatenate([corners, np.ones((4, 1, len(boxes)))], axis=1)  # [4, 3, N]
    warped = np.einsum("ij,cjn->cin", mat, pts)
    warped = warped[:, :2] / warped[:, 2:3]
    xs, ys = warped[:, 0], warped[:, 1]
    return np.stack([xs.min(0), ys.min(0), xs.max(0), ys.max(0)], axis=1).astype(np.float32)


def _filter_boxes(boxes: Boxes, labels: Labels, w: int, h: int,
                  min_size: float = 2.0) -> Tuple[Boxes, Labels]:
    """Clip to the w x h image, keep boxes wider and taller than min_size."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4), labels
    boxes = boxes.copy()
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = ((boxes[:, 2] - boxes[:, 0]) > min_size) & ((boxes[:, 3] - boxes[:, 1]) > min_size)
    return boxes[keep], labels[keep]


def _nearest_resize(img: np.ndarray, scale: float):
    """Nearest resize by `scale` (truncated sizes): (image, new h, new w)."""
    h, w = img.shape[:2]
    nh, nw = int(h * scale), int(w * scale)
    ys = (np.arange(nh) / scale).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(nw) / scale).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs], nh, nw


@dataclasses.dataclass
class Mosaic:
    """mmdet Mosaic (pad 114): a 2s x 2s canvas around a random centre, one
    image scaled to fit s in each quadrant."""

    img_scale: int = 640
    center_ratio_range: Tuple[float, float] = (0.5, 1.5)
    pad_val: float = 114.0

    def __call__(self, samples, rng: np.random.Generator):
        """samples: 4 (img, boxes, labels).  Returns (2s x 2s img, boxes, labels)."""
        s = self.img_scale
        canvas = np.full((2 * s, 2 * s, 3), self.pad_val, np.float32)
        cx = int(rng.uniform(*self.center_ratio_range) * s)
        cy = int(rng.uniform(*self.center_ratio_range) * s)
        out_boxes, out_labels = [], []
        for loc, (img, boxes, labels) in zip(("tl", "tr", "bl", "br"), samples):
            h, w = img.shape[:2]
            scale = min(s / h, s / w)
            im, nh, nw = _nearest_resize(img, scale)
            left, top = loc in ("tl", "bl"), loc in ("tl", "tr")
            x1, x2 = (max(cx - nw, 0), cx) if left else (cx, min(cx + nw, 2 * s))
            y1, y2 = (max(cy - nh, 0), cy) if top else (cy, min(cy + nh, 2 * s))
            # the crop of the scaled image that lands in the quadrant
            cw, ch = x2 - x1, y2 - y1
            sx1 = nw - cw if left else 0
            sy1 = nh - ch if top else 0
            canvas[y1:y2, x1:x2] = im[sy1:sy1 + ch, sx1:sx1 + cw]
            if len(boxes):
                b = boxes * scale
                b[:, 0::2] += x1 - sx1
                b[:, 1::2] += y1 - sy1
                b, lab = _filter_boxes(b, labels, 2 * s, 2 * s)
                # drop the boxes whose centre fell outside this quadrant's crop
                cxs = (b[:, 0] + b[:, 2]) / 2
                cys = (b[:, 1] + b[:, 3]) / 2
                inside = (cxs >= x1) & (cxs < x2) & (cys >= y1) & (cys < y2)
                out_boxes.append(b[inside])
                out_labels.append(lab[inside])
        boxes = np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(out_labels) if out_labels else np.zeros((0,), np.int32)
        return canvas, boxes, labels


@dataclasses.dataclass
class RandomAffine:
    """mmdet RandomAffine (rotate, scale, shear, translate) with the YOLOX
    overrides scaling_ratio_range=(0.1, 2) and border=(-s/2, -s/2), which
    halves the mosaic's 2s x 2s canvas back to s x s."""

    max_rotate_degree: float = 10.0
    max_translate_ratio: float = 0.1
    scaling_ratio_range: Tuple[float, float] = (0.1, 2.0)
    max_shear_degree: float = 2.0
    border: Tuple[int, int] = (0, 0)
    pad_val: float = 114.0

    def __call__(self, img, boxes, labels, rng: np.random.Generator):
        h = img.shape[0] + self.border[1] * 2
        w = img.shape[1] + self.border[0] * 2
        rot = np.deg2rad(rng.uniform(-self.max_rotate_degree, self.max_rotate_degree))
        scale = rng.uniform(*self.scaling_ratio_range)
        shx = np.deg2rad(rng.uniform(-self.max_shear_degree, self.max_shear_degree))
        shy = np.deg2rad(rng.uniform(-self.max_shear_degree, self.max_shear_degree))
        tx = rng.uniform(0.5 - self.max_translate_ratio, 0.5 + self.max_translate_ratio) * w
        ty = rng.uniform(0.5 - self.max_translate_ratio, 0.5 + self.max_translate_ratio) * h
        c, s = np.cos(rot), np.sin(rot)
        R = np.array([[c * scale, -s * scale, 0], [s * scale, c * scale, 0], [0, 0, 1]])
        Sh = np.array([[1, np.tan(shx), 0], [np.tan(shy), 1, 0], [0, 0, 1]])
        # the source image centred at the origin before R and Sh, then translated
        C = np.array([[1, 0, -img.shape[1] / 2], [0, 1, -img.shape[0] / 2], [0, 0, 1]])
        T = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]])
        mat = T @ Sh @ R @ C
        out = _affine_warp(img, mat, h, w, self.pad_val)
        boxes, labels = _filter_boxes(_transform_boxes(boxes, mat), labels, w, h)
        return out, boxes, labels


@dataclasses.dataclass
class MixUp:
    """mmdet's YOLOX MixUp: blended 0.5 / 0.5 with a second sample, scaled by
    a random jitter and maybe flipped; the annotations concatenated."""

    img_scale: int = 640
    ratio_range: Tuple[float, float] = (0.8, 1.6)
    flip_ratio: float = 0.5
    pad_val: float = 114.0

    def __call__(self, img, boxes, labels, other, rng: np.random.Generator):
        oimg, oboxes, olabels = other
        jit = rng.uniform(*self.ratio_range)
        flip = rng.random() < self.flip_ratio
        h, w = oimg.shape[:2]
        scale = min(self.img_scale / h, self.img_scale / w) * jit
        om, nh, nw = _nearest_resize(oimg, scale)
        ob = oboxes * scale if len(oboxes) else oboxes.reshape(0, 4)
        if flip:
            om = om[:, ::-1]
            if len(ob):
                ob = ob.copy()
                ob[:, [0, 2]] = nw - ob[:, [2, 0]]
        oh, ow = img.shape[:2]
        pasted = np.full((max(oh, nh), max(ow, nw), 3), self.pad_val, np.float32)
        pasted[:nh, :nw] = om
        pasted = pasted[:oh, :ow]
        out = 0.5 * img + 0.5 * pasted
        ob, ol = _filter_boxes(ob, olabels, ow, oh)
        return (out.astype(np.float32),
                np.concatenate([boxes, ob]) if len(ob) else boxes,
                np.concatenate([labels, ol]) if len(ol) else labels)


@dataclasses.dataclass
class HSVRandomAug:
    """mmdet YOLOXHSVRandomAug: gains of H (+-5), S (+-30) and V (+-30) in
    cv2's uint8 HSV space (H in [0, 180)), applied to the float HSV of
    `data/transforms.py` (H in [0, 360) degrees, S in [0, 1], V in [0, 255]):
    H x 2, S / 255, V as is."""

    hue_delta: float = 5.0
    saturation_delta: float = 30.0
    value_delta: float = 30.0

    def __call__(self, img, rng: np.random.Generator):
        hsv = bgr2hsv(np.clip(img, 0, 255))
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_delta, self.hue_delta) * 2.0) % 360.0
        hsv[..., 1] = np.clip(
            hsv[..., 1] + rng.uniform(-self.saturation_delta, self.saturation_delta) / 255.0,
            0.0, 1.0)
        hsv[..., 2] = np.clip(hsv[..., 2] + rng.uniform(-self.value_delta, self.value_delta),
                              0.0, 255.0)
        return hsv2bgr(hsv)


@dataclasses.dataclass
class YoloxTrainAugment:
    """The YOLOX train pipeline (reference yolox_x_8x8_300e_coco.py:33-52):
    Mosaic of 4 -> RandomAffine -> MixUp of 1 -> HSV -> flip, each stage
    switchable.  `get_sample(i)` returns (raw float32 BGR image, xyxy boxes,
    labels); the generator is seeded with `seed` once, at construction."""

    img_scale: int = 640
    enable_mosaic: bool = True
    enable_mixup: bool = True
    flip_ratio: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.mosaic = Mosaic(self.img_scale)
        self.affine = RandomAffine(border=(-self.img_scale // 2, -self.img_scale // 2))
        self.mixup = MixUp(self.img_scale)
        self.hsv = HSVRandomAug()

    def __call__(self, i: int, n: int, get_sample):
        rng = self._rng
        if self.enable_mosaic:
            idxs = [i] + [int(rng.integers(n)) for _ in range(3)]
            img, boxes, labels = self.mosaic([get_sample(j) for j in idxs], rng)
            img, boxes, labels = self.affine(img, boxes, labels, rng)
        else:
            img, boxes, labels = get_sample(i)
            img = img.astype(np.float32)
        if self.enable_mixup:
            other = get_sample(int(rng.integers(n)))
            img, boxes, labels = self.mixup(img, boxes, labels, other, rng)
        img = self.hsv(img, rng)
        if rng.random() < self.flip_ratio:
            img = img[:, ::-1].copy()
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = img.shape[1] - boxes[:, [2, 0]]
        return img, boxes, labels
