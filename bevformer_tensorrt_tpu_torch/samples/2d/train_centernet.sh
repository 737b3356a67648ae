#!/usr/bin/env bash
# centernet_r18 training (reference: tools/2d/train.py)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.train centernet_r18 \
  --ann "$COCO_ROOT/annotations/instances_train2017.json" \
  --img-root "$COCO_ROOT/train2017" --batch 16 --steps 10000 \
  --out checkpoints/centernet_r18.pth "$@"
