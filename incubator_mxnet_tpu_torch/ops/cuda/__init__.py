"""Hand-written CUDA kernels for Hopper (sm_90a), the counterparts of the
Pallas kernels of ``incubator_mxnet_tpu/ops/pallas/``. Sources live in
``csrc/``; ``_build`` compiles them with ``nvcc`` at first use."""
from . import conv_bn_relu, flash_attention, layer_norm

__all__ = ["conv_bn_relu", "flash_attention", "layer_norm"]
