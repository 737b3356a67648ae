#!/usr/bin/env bash
# Build the deployable artifact (reference: pth2onnx.sh + onnx2trt.sh); the kernels'
# libraries built for this card first (--aot)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.export small \
  --checkpoint checkpoints/bevformer_small_epoch_24.pth \
  --quant-scales checkpoints/small_scales.npz --quant int8 \
  --out checkpoints/small_program --aot "$@"
