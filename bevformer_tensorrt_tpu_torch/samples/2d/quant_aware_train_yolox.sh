#!/usr/bin/env bash
# yolox_x QAT fine-tune at the calibrated scales (reference: quant_aware_train.sh)
set -e
COCO_ROOT=${COCO_ROOT:-data/coco}
python -m bevformer_tensorrt_tpu_torch.tools.det2d.train yolox_x \
  --ann "$COCO_ROOT/annotations/instances_train2017.json" \
  --img-root "$COCO_ROOT/train2017" --batch 8 --steps 14786 \
  --checkpoint checkpoints/yolox_x.pth \
  --quant-scales checkpoints/yolox_x_scales.npz \
  --out checkpoints/yolox_x_qat.pth "$@"
