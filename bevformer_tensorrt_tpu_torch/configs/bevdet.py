"""Typed config for BEVDet R50 (CBGS) (a copy of
`bevformer_tensorrt_tpu/configs/bevdet.py`; the port imports nothing of the
JAX package).

Values cited from the reference configs/bevdet/bevdet-r50-cbgs.py
(grid_config, LSSViewTransformer, CustomResNet BEV encoder, CenterHead with
Scale-NMS test cfg).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BEVDetConfig:
    name: str = "bevdet-r50"
    num_cams: int = 6
    input_h: int = 256
    input_w: int = 704
    downsample: int = 16
    # backbone / necks
    backbone_depth: int = 50
    backbone_out_indices: Tuple[int, ...] = (2, 3)
    neck_out_channels: int = 256
    # LSS (grid_config: x/y [-51.2, 51.2, 0.8], z [-5, 3, 8], depth [1, 60, 1])
    grid_xbound: Tuple[float, float, float] = (-51.2, 51.2, 0.8)
    grid_ybound: Tuple[float, float, float] = (-51.2, 51.2, 0.8)
    grid_zbound: Tuple[float, float, float] = (-5.0, 3.0, 8.0)
    depth_bound: Tuple[float, float, float] = (1.0, 60.0, 1.0)
    view_channels: int = 64  # numC_Trans
    # bev encoder (CustomResNet num_channels = numC_Trans * (2, 4, 8))
    bev_channels: Tuple[int, ...] = (128, 256, 512)
    bev_out_channels: int = 256
    # head
    num_classes: int = 10
    share_conv_channel: int = 64
    code_size: int = 9
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    max_num: int = 500
    score_threshold: float = 0.1
    out_size_factor: int = 8
    voxel_size: Tuple[float, float] = (0.1, 0.1)
    nms_thr: float = 0.2
    nms_rescale_factor: Tuple[float, ...] = (1.0, 0.7, 0.7, 0.4, 0.55, 1.1, 1.0, 1.0, 1.5, 3.5)
    # deploy
    dtype: str = "float32"
    quant: bool = False
    quant_exclude: Tuple[str, ...] = ()  # mixed precision (quant/policy.py)

    @property
    def depth_bins(self) -> int:
        lo, hi, step = self.depth_bound
        return int(round((hi - lo) / step))

    @property
    def feat_h(self) -> int:
        return self.input_h // self.downsample

    @property
    def feat_w(self) -> int:
        return self.input_w // self.downsample

    @property
    def bev_h(self) -> int:
        lo, hi, step = self.grid_ybound
        return int(round((hi - lo) / step))

    @property
    def bev_w(self) -> int:
        lo, hi, step = self.grid_xbound
        return int(round((hi - lo) / step))


def bevdet_r50(**over) -> BEVDetConfig:
    d: dict = {}
    d.update(over)
    return BEVDetConfig(**d)


def bevdet_micro(**over) -> BEVDetConfig:
    """Micro variant for CI (not a reference config)."""
    d = dict(
        name="bevdet-micro",
        num_cams=2,
        input_h=64,
        input_w=128,
        view_channels=16,
        bev_channels=(32, 64, 128),
        bev_out_channels=64,
        share_conv_channel=16,
        grid_xbound=(-8.0, 8.0, 1.0),
        grid_ybound=(-8.0, 8.0, 1.0),
        depth_bound=(1.0, 9.0, 1.0),
        max_num=32,
        # decode consistency: centerpoint_decode maps grid cells back to
        # lidar via pc_range + voxel_size*out_size_factor — these must
        # equal the grid bounds/step (cell = 0.125*8 = 1.0 m over +-8 m),
        # or every decoded box lands at the wrong coordinates (r5: micro
        # accuracy cycle read mAP 0.0 from exactly this mismatch)
        pc_range=(-8.0, -8.0, -5.0, 8.0, 8.0, 3.0),
        post_center_range=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        voxel_size=(0.125, 0.125),
    )
    d.update(over)
    return BEVDetConfig(**d)
