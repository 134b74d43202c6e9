"""Gluon subset as ``torch.nn.Module``s (counterpart of
``incubator_mxnet_tpu/gluon``): layers, losses and the Trainer."""
from . import loss, nn
from .trainer import Trainer

__all__ = ["nn", "loss", "Trainer"]
