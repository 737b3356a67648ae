"""PyTorch + CUDA port of the BEVFormer inference path for NVIDIA Hopper.

Module paths mirror `bevformer_tensorrt_tpu/` so each port module sits at the
same relative path as its JAX counterpart.  The package imports torch and
numpy only.  Every Pallas kernel on the ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (`ops/_cuda.py`); each
kernel wrapper takes its plain PyTorch version for CPU tensors only.
"""
