"""PyTorch/CUDA port of ``flux_fp8_api_tpu``: the FLUX.1 fp8 image server on an
NVIDIA Hopper GPU.

Module paths and public names mirror the JAX package, so each function's counterpart
is found at the same path. The attention kernel is hand-written CUDA
(``csrc/qknorm_attention.cu``), built at first use; every other op is plain PyTorch.
This package never imports JAX.
"""
