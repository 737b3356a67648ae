#!/usr/bin/env bash
# QAT fine-tune from PTQ scales (reference quant_aware_train.sh recipe:
# short fine-tune at low lr with fake-quant inserted at the calibrated sites)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.train --model r50 \
  --infos "$DATA_ROOT/nuscenes_infos_train.pkl" \
  --data-root "$DATA_ROOT" --checkpoint checkpoints/bevdet_r50.pth \
  --quant-scales checkpoints/bevdet_scales.npz \
  --steps 2000 --out checkpoints/bevdet_qat.pth "$@"
