"""Ops of the port: plain PyTorch versions beside the CUDA kernel wrappers."""
from .attention import (
    flash_attention,
    flash_attention_int8,
    flash_attention_int8_plain,
    multi_head_attention,
    qkv_plain,
)
from .dcn import (
    dcn_gather_table,
    deform_im2col,
    deform_im2col_int8,
    deform_im2col_int8_plain,
    deform_im2col_plain,
    modulated_deform_conv2d,
    modulated_deform_conv2d_int8,
    modulated_deform_conv2d_int8_plain,
    modulated_deform_conv2d_plain,
    quantize_dcn_table,
)
from .gather_probe import gather_blend, gather_blend_plain, gather_rows, gather_rows_plain
from .grid_sample import grid_sample_2d, grid_sample_3d, grid_sampler
from . import int8_matmul  # the module: its wrapper shares the name
from .inverse import inverse, inverse_4x4  # the function shadows its module here
from .msda import (
    msda_sampling_locations,
    multi_scale_deformable_attn,
    multi_scale_deformable_attn_int8,
    multi_scale_deformable_attn_int8_plain,
    multi_scale_deformable_attn_plain,
)
from .rotate import rotate
from .voxel import points_in_rotated_boxes, roiaware_pool3d, voxelize

# every function that carries a launch count, in the order the smoke run
# reports them: the model's kernels (the DCN op's fused kernel from the float
# map and from the int8 table, then the channels-last gather table it reads,
# made by `dcn_gather_table`), the two probes of the kernel bench tool, then
# the two deformable im2col kernels that the DCN op used before the fused
# kernel, kept as its yardstick off every path
KERNEL_WRAPPERS = (multi_scale_deformable_attn, flash_attention, modulated_deform_conv2d,
                   int8_matmul.int8_matmul, multi_scale_deformable_attn_int8,
                   flash_attention_int8, modulated_deform_conv2d_int8, dcn_gather_table,
                   gather_rows, gather_blend, deform_im2col, deform_im2col_int8)


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
    "dcn_gather_table",
    "deform_im2col",
    "deform_im2col_int8",
    "deform_im2col_int8_plain",
    "deform_im2col_plain",
    "gather_blend",
    "gather_blend_plain",
    "gather_rows",
    "gather_rows_plain",
    "grid_sample_2d",
    "grid_sample_3d",
    "grid_sampler",
    "inverse",
    "inverse_4x4",
    "quantize_dcn_table",
    "modulated_deform_conv2d",
    "modulated_deform_conv2d_int8",
    "modulated_deform_conv2d_int8_plain",
    "modulated_deform_conv2d_plain",
    "msda_sampling_locations",
    "multi_scale_deformable_attn",
    "multi_scale_deformable_attn_int8",
    "multi_scale_deformable_attn_int8_plain",
    "multi_scale_deformable_attn_plain",
    "points_in_rotated_boxes",
    "roiaware_pool3d",
    "rotate",
    "voxelize",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]
