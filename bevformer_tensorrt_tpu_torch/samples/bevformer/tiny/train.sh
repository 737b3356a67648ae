#!/usr/bin/env bash
# Training (reference: train.sh); several cards: torchrun ... --distributed
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.train tiny \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_train.pkl" \
  --data-root "$DATA_ROOT" --steps 20000 --out checkpoints/tiny.pth "$@"
