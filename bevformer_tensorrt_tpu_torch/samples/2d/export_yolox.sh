#!/usr/bin/env bash
# Export the yolox_x program (reference: the export + onnx2trt chain)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.det2d.export yolox_x --dtype bfloat16 --quant int8 \
  --quant-scales checkpoints/yolox_x_scales.npz --out artifacts/yolox_x "$@"
