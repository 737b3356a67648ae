#!/usr/bin/env bash
# Build the deployable artifact (reference: pth2onnx.sh + onnx2trt.sh); the kernels'
# libraries built for this card first (--aot)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.export base \
  --checkpoint checkpoints/bevformer_base_epoch_24.pth \
  --quant-scales checkpoints/base_scales.npz --quant int8 \
  --out checkpoints/base_program --aot "$@"
