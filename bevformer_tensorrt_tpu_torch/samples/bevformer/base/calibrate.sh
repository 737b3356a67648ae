#!/usr/bin/env bash
# INT8 PTQ calibration -> scales (reference: onnx2trt.sh --int8)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.calibrate base \
  --infos "$DATA_ROOT/nuscenes_infos_temporal_val.pkl" \
  --data-root "$DATA_ROOT" --length 500 --method percentile \
  --out checkpoints/base_scales.npz "$@"
