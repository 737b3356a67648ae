#!/usr/bin/env bash
# INT8 evaluation with calibrated scales
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.evaluate small \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_val.pkl" \
  --data-root "$DATA_ROOT" --dtype bfloat16 \
  --quant-scales checkpoints/small_scales.npz --quant int8 "$@"
