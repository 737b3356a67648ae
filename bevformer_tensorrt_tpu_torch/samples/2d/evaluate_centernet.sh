#!/usr/bin/env bash
# centernet_r18 evaluation on COCO val2017
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.evaluate centernet_r18 \
  --ann "$COCO_ROOT/annotations/instances_val2017.json" \
  --img-root "$COCO_ROOT/val2017" --batch 32 "$@"
