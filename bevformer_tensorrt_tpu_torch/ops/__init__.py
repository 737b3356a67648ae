"""Ops of the port: plain PyTorch versions beside the CUDA kernel wrappers."""
from .attention import (
    flash_attention,
    flash_attention_int8,
    flash_attention_int8_plain,
    multi_head_attention,
    qkv_plain,
)
from .dcn import (
    deform_im2col,
    deform_im2col_plain,
    modulated_deform_conv2d,
    modulated_deform_conv2d_plain,
)
from . import int8_matmul  # the module: its wrapper shares the name
from .msda import (
    msda_sampling_locations,
    multi_scale_deformable_attn,
    multi_scale_deformable_attn_int8,
    multi_scale_deformable_attn_int8_plain,
    multi_scale_deformable_attn_plain,
)
from .rotate import rotate

KERNEL_WRAPPERS = (multi_scale_deformable_attn, flash_attention, modulated_deform_conv2d,
                   int8_matmul.int8_matmul, multi_scale_deformable_attn_int8,
                   flash_attention_int8)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "flash_attention",
    "flash_attention_int8",
    "flash_attention_int8_plain",
    "int8_matmul",
    "multi_head_attention",
    "qkv_plain",
    "deform_im2col",
    "deform_im2col_plain",
    "modulated_deform_conv2d",
    "modulated_deform_conv2d_plain",
    "msda_sampling_locations",
    "multi_scale_deformable_attn",
    "multi_scale_deformable_attn_int8",
    "multi_scale_deformable_attn_int8_plain",
    "multi_scale_deformable_attn_plain",
    "rotate",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]
