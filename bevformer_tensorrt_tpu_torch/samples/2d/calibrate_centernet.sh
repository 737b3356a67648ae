#!/usr/bin/env bash
# INT8 PTQ calibration for centernet_r18 (reference: post_training_quant.sh)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.calibrate centernet_r18 \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --length 512 --method percentile \
  --out checkpoints/centernet_r18_scales.npz "$@"
