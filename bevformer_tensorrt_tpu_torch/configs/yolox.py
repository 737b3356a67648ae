"""Typed config for YOLOX (reference configs/yolox/yolox_x_8x8_300e_coco.py) (a copy of
`bevformer_tensorrt_tpu/configs/yolox.py`; the port imports nothing of the
JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class YOLOXConfig:
    name: str = "yolox-x"
    img_size: int = 640
    num_classes: int = 80
    deepen_factor: float = 1.33
    widen_factor: float = 1.25
    neck_channels: int = 320
    num_csp_blocks: int = 4
    score_thr: float = 0.01
    nms_iou: float = 0.65
    max_per_img: int = 100
    dtype: str = "float32"
    quant: bool = False
    quant_exclude: Tuple[str, ...] = ()  # mixed precision (quant/policy.py)


def yolox_x(**over) -> YOLOXConfig:
    return YOLOXConfig(**over)


def yolox_s(**over) -> YOLOXConfig:
    """Standard -s scaling (0.33/0.5) — the north-star's 2D PTQ config."""
    d = dict(name="yolox-s", deepen_factor=0.33, widen_factor=0.5,
             neck_channels=128, num_csp_blocks=1)
    d.update(over)
    return YOLOXConfig(**d)


def yolox_micro(**over) -> YOLOXConfig:
    d = dict(name="yolox-micro", img_size=64, deepen_factor=0.33,
             widen_factor=0.125, neck_channels=32, num_csp_blocks=1)
    d.update(over)
    return YOLOXConfig(**d)
