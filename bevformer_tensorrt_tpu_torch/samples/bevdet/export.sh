#!/usr/bin/env bash
# Export the BEVDet program with the ranks of the set's first rig baked in
# (reference: bevdet export_onnx.py + onnx2trt.sh)
set -e
DATA_ROOT=${DATA_ROOT:-data/nuscenes}
python -m bevformer_tensorrt_tpu_torch.tools.bevdet.export --model r50 --infos "$DATA_ROOT/nuscenes_infos_val.pkl" \
  --data-root "$DATA_ROOT" --dtype bfloat16 --quant int8 \
  --quant-scales checkpoints/bevdet_scales.npz --out artifacts/bevdet_r50 "$@"
