"""Operators on torch tensors (counterpart of ``incubator_mxnet_tpu/ops``):
plain functions in ``_raw``, the kernel selection rules in ``select``, the
hand-written CUDA kernels in ``cuda``, and the ``ConvBNReLU`` and
``Dropout`` ops."""
from .. import autograd
from . import _raw, cuda, select
from ._raw import (OOR_POLICIES, activation, batch_norm, conv,
                   conv_bn_relu, dropout, embedding, fully_connected, gelu,
                   layer_norm, multihead_attention, normalize_ids, pooling,
                   relu, softmax_cross_entropy, tanh)

__all__ = ["OOR_POLICIES", "cuda", "select", "activation", "batch_norm",
           "conv", "conv_bn_relu", "ConvBNReLU", "dropout", "Dropout", "embedding",
           "fully_connected", "gelu", "layer_norm", "multihead_attention",
           "normalize_ids", "pooling", "relu", "softmax_cross_entropy",
           "tanh"]


def ConvBNReLU(data, weight, gamma, beta, moving_mean, moving_var, *,
               eps=1e-5, stride=None, pad=None, dilate=None, num_group=1,
               layout="NHWC", act_type="relu"):
    """Fused conv + BatchNorm + activation, the serving hot path. In predict
    mode (outside ``autograd.record()``) a qualifying call runs the fused
    kernels (1x1 convs as one GEMM with the epilogue); otherwise the op is
    the exact conv -> BN -> act chain. The moving statistics are read, never
    written: training graphs keep separate Conv and BatchNorm blocks so that
    the statistics update."""
    return _raw.conv_bn_relu(data, weight, gamma, beta, moving_mean,
                             moving_var, eps=eps, stride=stride, pad=pad,
                             dilate=dilate, num_group=num_group,
                             layout=layout, act=act_type,
                             training=autograd.is_training())


def Dropout(data, p=0.5, mode="training", axes=(), generator=None):
    """Dropout in training mode (inside ``autograd.record()``) or, with
    ``mode="always"``, everywhere; `axes` share one mask along them. The
    mask comes from `generator`, by default the seeded generator of the
    input's device (``random.generator``)."""
    training = autograd.is_training() or mode == "always"
    return _raw.dropout(data, p, training, generator, axes)
