#!/usr/bin/env bash
# QAT fine-tune from PTQ scales at lr 1e-6 (reference quant_aware_train.sh)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.train tiny \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_train.pkl" \
  --data-root "$DATA_ROOT" --checkpoint checkpoints/tiny.pth \
  --quant-scales checkpoints/tiny_scales.npz \
  --steps 7000 --out checkpoints/tiny_qat.pth "$@"
