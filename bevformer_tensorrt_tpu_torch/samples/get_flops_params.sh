#!/usr/bin/env bash
# FLOPs and parameter counts per model tier (reference: samples/get_flops_params.sh)
set -e
for m in tiny small base; do
  python -m bevformer_tensorrt_tpu_torch.tools.flops_params "$m" "$@"
done
