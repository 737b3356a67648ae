#!/usr/bin/env bash
# INT8 evaluation for centernet_r18 at calibrated scales
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.evaluate centernet_r18 \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --batch 32 \
  --quant-scales checkpoints/centernet_r18_scales.npz --quant int8 "$@"
