"""Gluon (counterpart of ``incubator_mxnet_tpu/gluon``): Parameter and
ParameterDict, Block and HybridBlock (``torch.nn.Module`` subclasses with
MXNet's names, deferred shapes and ``hybridize``), the layers, the losses
and the Trainer."""
from . import block, loss, nn, parameter
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["nn", "loss", "block", "parameter", "Trainer", "Block",
           "HybridBlock", "SymbolBlock", "Parameter", "ParameterDict",
           "Constant", "DeferredInitializationError"]
