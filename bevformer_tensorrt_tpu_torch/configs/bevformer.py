"""Typed configs for the BEVFormer family (tiny / small / base).

Replaces the reference's 4-tier mmcv config inheritance
(configs/bevformer/{bevformer_<v>.py -> _trt.py -> _trt_q.py -> plugin/*})
with frozen dataclasses: the model tier is the dataclass, the deploy tier is
`dtype`, the quant tier is `quant`, and the kernel-variant tier is
`msda_impl` (jnp/XLA vs Pallas).  Hyperparameters cited from
configs/bevformer/bevformer_{tiny,small,base}.py.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BEVFormerConfig:
    name: str = "base"
    # transformer
    embed_dims: int = 256
    num_heads: int = 8
    ffn_dims: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_points_in_pillar: int = 4
    num_points_cross: int = 8   # MSDeformableAttention3D num_points
    num_points_self: int = 4    # TemporalSelfAttention num_points
    num_points_decoder: int = 4  # CustomMSDeformableAttention num_points
    num_levels: int = 4
    num_cams: int = 6
    # bev grid
    bev_h: int = 200
    bev_w: int = 200
    num_query: int = 900
    num_classes: int = 10
    code_size: int = 10
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    real_h: float = 102.4
    real_w: float = 102.4
    rotate_center: Tuple[int, int] = (100, 100)
    can_bus_dims: int = 18
    use_shift: bool = True
    use_can_bus: bool = True
    rotate_prev_bev: bool = True
    use_cams_embeds: bool = True
    # image / backbone (base deploy shape: configs/bevformer/bevformer_base_trt.py:76-77)
    img_h: int = 928
    img_w: int = 1600
    backbone_depth: int = 101
    backbone_out_indices: Tuple[int, ...] = (1, 2, 3)
    dcn_stages: Tuple[bool, ...] = (False, False, True, True)
    # deploy
    dtype: str = "float32"  # compute dtype for backbone/attention matmuls
    quant: bool = False     # False | True (QDQ sim) | 'int8' (real int8)
    # mixed precision: module-path patterns that stay in the compute dtype
    # under quant (the reference's INT8+FP16 dual-flag behavior where TRT
    # keeps sensitive layers fp16, det2trt/convert/onnx2tensorrt.py:49-54);
    # see quant/policy.py for pattern semantics
    quant_exclude: Tuple[str, ...] = ()
    msda_impl: str = "auto"  # 'jnp' | 'pallas' | 'auto'
    # per-camera query budget for spatial cross-attention (fraction of BEV
    # queries gathered per camera; 1.0 disables compaction).  Exact as long
    # as every camera sees fewer than budget*nq queries — a 70-120 degree
    # camera in a 360 rig sees ~20-30% of the BEV grid, so 0.35 keeps
    # headroom while cutting the gather work ~3x.
    cam_budget: float = 0.35

    @property
    def grid_length(self) -> Tuple[float, float]:
        return (self.real_h / self.bev_h, self.real_w / self.bev_w)

    @property
    def head_dim(self) -> int:
        return self.embed_dims // self.num_heads


def _int8_defaults(d: dict, over: dict) -> dict:
    """Default mixed-precision policy for quant='int8' tiers.

    The temporal self-attention value tables stay bf16-packed under int8:
    the in-model int8 TSA table program faults the v5e TPU worker at base
    shapes (r5 investigation, NOTES_r5.md — data-dependent, survives every
    kernel-layout variant, never reproduces standalone; all runs with the
    TSA tables excluded are clean).  This mirrors the reference, which
    never ships pure INT8 either: every int8 engine is built with the FP16
    dual flag so TensorRT keeps fault- or accuracy-sensitive layers fp16
    per layer (det2trt/convert/onnx2tensorrt.py:49-54).  Cost is small:
    int8 tables buy only ~1.1-1.3x on the gather kernels (OPBENCH_r4) and
    the TSA is ~10% of the frame.  An explicit quant_exclude override
    disables this default.
    """
    merged = {**d, **over}
    if merged.get("quant") == "int8" and "quant_exclude" not in over:
        d = {**d, "quant_exclude": ("self_attn/msda_tables",)}
    return d


def bevformer_tiny(**over) -> BEVFormerConfig:
    """configs/bevformer/bevformer_tiny.py: R50 (last stage), 1 FPN level,
    50x50 BEV, 3 encoder layers, 480x800 input."""
    d = dict(
        name="tiny",
        encoder_layers=3,
        num_levels=1,
        bev_h=50,
        bev_w=50,
        img_h=480,
        img_w=800,
        backbone_depth=50,
        backbone_out_indices=(3,),
        dcn_stages=(False, False, False, False),
    )
    d = _int8_defaults(d, over)
    d.update(over)
    return BEVFormerConfig(**d)


def bevformer_small(**over) -> BEVFormerConfig:
    """configs/bevformer/bevformer_small.py: R101-DCN, 1 FPN level,
    150x150 BEV, 3 encoder layers, 736x1280 input."""
    d = dict(
        name="small",
        encoder_layers=3,
        num_levels=1,
        bev_h=150,
        bev_w=150,
        img_h=736,
        img_w=1280,
        backbone_depth=101,
        backbone_out_indices=(3,),
        dcn_stages=(False, False, True, True),
    )
    d = _int8_defaults(d, over)
    d.update(over)
    return BEVFormerConfig(**d)


def bevformer_micro(**over) -> BEVFormerConfig:
    """Micro config for CI / virtual-mesh dryruns: same topology as tiny
    (R50, 1 FPN level, single-frame) at shapes that compile+run in seconds
    on a CPU-simulated mesh. Not a reference config — test infrastructure."""
    d = dict(
        name="micro",
        embed_dims=64,
        ffn_dims=128,
        encoder_layers=2,
        decoder_layers=2,
        num_levels=1,
        num_cams=2,
        bev_h=8,
        bev_w=8,
        num_query=16,
        img_h=96,
        img_w=160,
        backbone_depth=50,
        backbone_out_indices=(3,),
        dcn_stages=(False, False, False, False),
        rotate_center=(4, 4),
    )
    d = _int8_defaults(d, over)
    d.update(over)
    return BEVFormerConfig(**d)


def bevformer_base(**over) -> BEVFormerConfig:
    """configs/bevformer/bevformer_base.py: R101-DCN, 4 FPN levels,
    200x200 BEV, 6 encoder layers, 900x1600 input."""
    d = dict(name="base")
    d = _int8_defaults(d, over)
    d.update(over)
    return BEVFormerConfig(**d)
