#!/usr/bin/env bash
# INT8 PTQ calibration for BEVDet (reference: bevdet onnx2trt.sh --int8)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.calibrate \
  --infos "$DATA_ROOT/nuscenes_infos_val.pkl" \
  --data-root "$DATA_ROOT" --length 500 --method percentile \
  --out checkpoints/bevdet_scales.npz "$@"
