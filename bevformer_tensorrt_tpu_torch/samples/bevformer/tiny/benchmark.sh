#!/usr/bin/env bash
# Frame latency of BEVFormer-tiny on the card (the JAX sample ran bench.py)
set -e
python -m bevformer_tensorrt_tpu_torch.tools.benchmark_all --models tiny --dtype bfloat16 "$@"
