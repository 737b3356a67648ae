#!/usr/bin/env bash
# INT8 evaluation for yolox_x at calibrated scales
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.evaluate yolox_x \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --batch 32 \
  --quant-scales checkpoints/yolox_x_scales.npz --quant int8 "$@"
