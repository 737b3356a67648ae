#!/usr/bin/env bash
# yolox_x training (reference: tools/2d/train.py)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.train yolox_x \
  --ann "$COCO_ROOT/annotations/instances_train2017.json" \
  --img-root "$COCO_ROOT/train2017" --batch 8 --steps 10000 \
  --out checkpoints/yolox_x.pth "$@"
