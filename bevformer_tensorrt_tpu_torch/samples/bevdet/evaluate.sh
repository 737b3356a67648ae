#!/usr/bin/env bash
# BEVDet evaluation on nuScenes val
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.evaluate \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_val.pkl" --data-root "$DATA_ROOT" "$@"
