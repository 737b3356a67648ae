#!/usr/bin/env bash
# centernet_r18 QAT fine-tune at the calibrated scales (reference: quant_aware_train.sh)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.train centernet_r18 \
  --ann "$COCO_ROOT/annotations/instances_train2017.json" \
  --img-root "$COCO_ROOT/train2017" --batch 16 --steps 2000 \
  --checkpoint checkpoints/centernet_r18.pth \
  --quant-scales checkpoints/centernet_r18_scales.npz \
  --out checkpoints/centernet_r18_qat.pth "$@"
