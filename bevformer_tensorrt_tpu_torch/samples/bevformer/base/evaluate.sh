#!/usr/bin/env bash
# Floating-point evaluation on nuScenes val (reference: samples/bevformer/base/*evaluate*.sh)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.evaluate base \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_val.pkl" \
  --data-root "$DATA_ROOT" --dtype bfloat16 "$@"
