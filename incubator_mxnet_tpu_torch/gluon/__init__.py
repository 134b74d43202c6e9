"""Gluon layer subset as ``torch.nn.Module``s (counterpart of
``incubator_mxnet_tpu/gluon``)."""
from . import nn

__all__ = ["nn"]
