#!/usr/bin/env bash
# Temporal-queue training: 4-frame clips, 3 no-grad history frames building
# prev_bev, gradients on the last frame only (reference:
# third_party/bev_mmdet3d/models/detectors/bevformer.py:168-192).
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.train small \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_train.pkl" \
  --data-root "$DATA_ROOT" --temporal --queue-length 4 \
  --steps 20000 --out checkpoints/small_temporal.pth "$@"
