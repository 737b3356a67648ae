"""Ops of the port: plain PyTorch versions beside the CUDA kernel wrappers."""
from .attention import flash_attention, multi_head_attention, qkv_plain
from .dcn import (
    deform_im2col,
    deform_im2col_plain,
    modulated_deform_conv2d,
    modulated_deform_conv2d_plain,
)
from .msda import (
    msda_sampling_locations,
    multi_scale_deformable_attn,
    multi_scale_deformable_attn_plain,
)
from .rotate import rotate

KERNEL_WRAPPERS = (multi_scale_deformable_attn, flash_attention, modulated_deform_conv2d)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "flash_attention",
    "multi_head_attention",
    "qkv_plain",
    "deform_im2col",
    "deform_im2col_plain",
    "modulated_deform_conv2d",
    "modulated_deform_conv2d_plain",
    "msda_sampling_locations",
    "multi_scale_deformable_attn",
    "multi_scale_deformable_attn_plain",
    "rotate",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]
