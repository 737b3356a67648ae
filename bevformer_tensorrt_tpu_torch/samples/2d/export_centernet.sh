#!/usr/bin/env bash
# Export the centernet_r18 program (reference: the export + onnx2trt chain)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.det2d.export centernet_r18 --dtype bfloat16 --quant int8 \
  --quant-scales checkpoints/centernet_r18_scales.npz --out artifacts/centernet_r18 "$@"
