"""Train-time multi-view image augmentation
(port of `bevformer_tensorrt_tpu/data/transforms.py`).

Equivalents of the reference's train pipeline transforms
(upstream datasets/pipelines/transform_3d.py):
  * PhotoMetricDistortionMultiViewImage (:195-281) — random brightness,
    contrast (before or after HSV), saturation, hue, channel swap; each
    applied with probability 0.5, per camera image.
  * RandomScaleImageMultiViewImage (:404-437) — one scale for all views,
    bilinear resize + the matching [4,4] scale of lidar2img.

All numpy, on the host (augmentation runs in the data loader), driven by an
explicit np.random.Generator so clips are reproducible.  Images are float32
BGR in [0, 255] BEFORE normalization — the reference applies photometric
distortion between Load and Normalize.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """float32 BGR -> HSV with H in [0, 360), S in [0, 1], V in input scale
    (the cv2 float-image convention mmcv.bgr2hsv delegates to)."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    mn = np.minimum(np.minimum(b, g), r)
    diff = v - mn
    safe = np.maximum(diff, 1e-12)
    h = np.where(
        v == r,
        60.0 * (g - b) / safe,
        np.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = np.where(diff > 0, h % 360.0, 0.0)
    s = np.where(v > 1e-12, diff / np.maximum(v, 1e-12), 0.0)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """Inverse of bgr2hsv (H wraps mod 360; S clipped to [0, 1])."""
    h = (img[..., 0] % 360.0) / 60.0
    s = np.clip(img[..., 1], 0.0, 1.0)
    v = img[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([b, g, r], axis=-1).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W, C] float32 bilinear resize (align_corners=False / half-pixel,
    matching cv2.resize INTER_LINEAR which mmcv.imresize uses)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


@dataclasses.dataclass
class PhotoMetricDistortion:
    """Per-image photometric jitter (reference transform_3d.py:195-281).
    Operates on float32 BGR [0, 255] images; every step fires with p=0.5."""

    brightness_delta: float = 32.0
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    saturation_range: Tuple[float, float] = (0.5, 1.5)
    hue_delta: float = 18.0

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = img.astype(np.float32)
        if rng.integers(2):
            img = img + rng.uniform(-self.brightness_delta, self.brightness_delta)
        mode = int(rng.integers(2))
        if mode == 1 and rng.integers(2):
            img = img * rng.uniform(*self.contrast_range)
        hsv = bgr2hsv(np.clip(img, 0.0, None))
        if rng.integers(2):
            hsv[..., 1] *= rng.uniform(*self.saturation_range)
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_delta, self.hue_delta)) % 360.0
        img = hsv2bgr(hsv)
        if mode == 0 and rng.integers(2):
            img = img * rng.uniform(*self.contrast_range)
        if rng.integers(2):
            img = img[..., rng.permutation(3)]
        return img


@dataclasses.dataclass
class RandomScaleImage:
    """One random scale from `scales` applied to every view's image AND its
    lidar2img (reference transform_3d.py:404-437: scale_factor @ l2i)."""

    scales: Sequence[float] = (1.0,)

    def __call__(
        self, imgs: List[np.ndarray], lidar2img: np.ndarray, rng: np.random.Generator
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        s = float(self.scales[int(rng.integers(len(self.scales)))])
        if s == 1.0:
            return imgs, lidar2img
        out = [
            resize_bilinear(im, int(im.shape[0] * s), int(im.shape[1] * s))
            for im in imgs
        ]
        sf = np.eye(4, dtype=lidar2img.dtype)
        sf[0, 0] = s
        sf[1, 1] = s
        return out, sf @ lidar2img


@dataclasses.dataclass
class MultiViewTrainAugment:
    """The reference BEVFormer train pipeline's augmentation block:
    PhotoMetricDistortionMultiViewImage (+ optional RandomScale).  Called by
    NuScenesFrames between load and normalize with the raw float32 BGR
    views and the [cams, 4, 4] lidar2img stack."""

    photometric: Optional[PhotoMetricDistortion] = dataclasses.field(
        default_factory=PhotoMetricDistortion
    )
    scale: Optional[RandomScaleImage] = None
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(
        self, imgs: List[np.ndarray], lidar2img: np.ndarray
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        if self.photometric is not None:
            imgs = [self.photometric(im, self._rng) for im in imgs]
        if self.scale is not None:
            imgs, lidar2img = self.scale(imgs, lidar2img, self._rng)
        return imgs, lidar2img
