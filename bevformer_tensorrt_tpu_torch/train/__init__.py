"""BEVFormer training (port of `bevformer_tensorrt_tpu/train/`): the DETR
losses and match costs, the host Hungarian assigner, the AdamW recipe and the
single-frame and temporal-queue steps."""
from .assigner import assign_levels, hungarian_assign
from .losses import bbox_l1_cost, focal_cls_cost, normalize_bbox, sigmoid_focal_loss
from .step import (
    Optimizer,
    bevformer_detr_loss,
    check_quant_scales,
    init_train_state,
    loss_fn,
    temporal_loss_fn,
    temporal_train_step,
    train_step,
)

__all__ = [
    "Optimizer",
    "assign_levels",
    "bbox_l1_cost",
    "bevformer_detr_loss",
    "check_quant_scales",
    "focal_cls_cost",
    "hungarian_assign",
    "init_train_state",
    "loss_fn",
    "normalize_bbox",
    "sigmoid_focal_loss",
    "temporal_loss_fn",
    "temporal_train_step",
    "train_step",
]
