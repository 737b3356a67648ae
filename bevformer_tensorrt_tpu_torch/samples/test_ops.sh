#!/usr/bin/env bash
# Op tests (reference: samples/test_trt_ops.sh).  Two surfaces:
#   1. the CPU tests of the port's ops against the JAX package
#   2. --device: every kernel x precision at the deploy shapes on the card,
#      with adversarial data, each case its own process
#      (tools/device_op_check.py)
set -e
if [ "$1" = "--device" ]; then
  shift
  python -m bevformer_tensorrt_tpu_torch.tools.device_op_check "$@"
else
  python -m pytest tests/test_torch_ops.py tests/test_torch_ops_misc.py \
    tests/test_torch_kernel_geometry.py tests/test_torch_dcn_fused.py -q
fi
