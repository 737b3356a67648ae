#!/usr/bin/env bash
# yolox_x evaluation on COCO val2017
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.evaluate yolox_x \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --batch 32 "$@"
