#!/usr/bin/env bash
# BEVDet training (reference: bev_mmdet3d train APIs + bevdet-r50-cbgs.py)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.train --model r50 \
  --infos "$DATA_ROOT/nuscenes_infos_train.pkl" \
  --data-root "$DATA_ROOT" --steps 5000 \
  --out checkpoints/bevdet_r50.pth "$@"
