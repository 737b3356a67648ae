#!/usr/bin/env bash
# Build the deployable artifact (reference: pth2onnx.sh + onnx2trt.sh); the kernels'
# libraries built for this card first (--aot)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.export tiny \
  --checkpoint checkpoints/bevformer_tiny_epoch_24.pth \
  --quant-scales checkpoints/tiny_scales.npz --quant int8 \
  --out checkpoints/tiny_program --aot "$@"
