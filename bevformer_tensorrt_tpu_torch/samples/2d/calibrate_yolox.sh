#!/usr/bin/env bash
# INT8 PTQ calibration for yolox_x (reference: post_training_quant.sh)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.calibrate yolox_x \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --length 512 --method max \
  --out checkpoints/yolox_x_scales.npz "$@"
