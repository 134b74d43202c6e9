"""Operators on torch tensors (counterpart of ``incubator_mxnet_tpu/ops``):
plain functions in ``_raw``, the kernel selection rules in ``select`` and
the hand-written CUDA kernels in ``cuda``."""
from . import cuda, select
from ._raw import (activation, dropout, embedding, fully_connected, gelu,
                   layer_norm, multihead_attention, normalize_ids,
                   softmax_cross_entropy, tanh)

__all__ = ["cuda", "select", "activation", "dropout", "embedding",
           "fully_connected", "gelu", "layer_norm", "multihead_attention",
           "normalize_ids", "softmax_cross_entropy", "tanh"]
