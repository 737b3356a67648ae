"""Typed config for CenterNet (reference
configs/centernet/centernet_resnet18_dcnv2_140e_coco.py) (a copy of
`bevformer_tensorrt_tpu/configs/centernet.py`; the port imports nothing of the
JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CenterNetConfig:
    name: str = "centernet-r18"
    img_size: int = 640
    num_classes: int = 80
    backbone_depth: int = 18
    deconv_filters: Tuple[int, ...] = (256, 128, 64)
    use_dcn: bool = True
    topk: int = 100
    local_max_kernel: int = 3
    dtype: str = "float32"
    quant: bool = False
    quant_exclude: Tuple[str, ...] = ()  # mixed precision (quant/policy.py)


def centernet_r18(**over) -> CenterNetConfig:
    return CenterNetConfig(**over)


def centernet_micro(**over) -> CenterNetConfig:
    d = dict(name="centernet-micro", img_size=64, deconv_filters=(32, 16, 16),
             use_dcn=False, topk=20)
    d.update(over)
    return CenterNetConfig(**d)
