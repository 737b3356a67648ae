#!/usr/bin/env bash
# QAT fine-tune from PTQ scales at lr 1e-6 (reference quant_aware_train.sh)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.train small \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_train.pkl" \
  --data-root "$DATA_ROOT" --checkpoint checkpoints/small.pth \
  --quant-scales checkpoints/small_scales.npz \
  --steps 7000 --out checkpoints/small_qat.pth "$@"
