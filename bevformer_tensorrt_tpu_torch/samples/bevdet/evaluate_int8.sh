#!/usr/bin/env bash
# INT8 evaluation at the calibrated scales (reference: bevdet evaluate_trt.sh)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.evaluate \
  --infos "$DATA_ROOT/nuscenes_infos_val.pkl" \
  --data-root "$DATA_ROOT" --quant-scales checkpoints/bevdet_scales.npz --quant int8 "$@"
