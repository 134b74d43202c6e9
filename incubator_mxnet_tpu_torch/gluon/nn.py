"""Layers as ``torch.nn.Module``s: the subset of
``incubator_mxnet_tpu/gluon/nn/__init__.py`` that BERT, the causal LM and
ResNet need.

Parameter names and shapes follow the JAX package (Dense ``weight`` is
(units, in_units); an NHWC Conv2D ``weight`` is kernel + (in_channels,
channels); LayerNorm and BatchNorm have ``gamma`` and ``beta``), so a
module's ``state_dict`` keys are the JAX side's structural names.
BatchNorm's ``running_mean`` and ``running_var`` are buffers: the JAX side
lists them among its parameters with ``grad_req="null"``. Shapes are given
at construction: there is no deferred shape inference. Parameters start
deterministic (weights and biases zero, gamma one, running_var one);
:func:`init_params` draws the weights from a seeded generator.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import autograd, ops

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout", "GELU",
           "Embedding", "LayerNorm", "Conv2D", "BatchNorm", "BatchNormReLU",
           "MaxPool2D", "GlobalAvgPool2D", "Flatten", "init_params"]


class HybridSequential(nn.Sequential):
    """Children named "0", "1", ... in the order added."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self)), b)


class Dense(nn.Module):
    """FullyConnected layer; weight (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units (shapes are fixed at "
                             "construction)")
        self._flatten = flatten
        self.act = activation
        self.weight = nn.Parameter(torch.zeros(units, in_units))
        self.bias = nn.Parameter(torch.zeros(units)) if use_bias else None

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias, self._flatten)
        if self.act:
            out = ops.activation(out, self.act)
        return out


class Activation(nn.Module):
    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return ops.activation(x, self._act)


class Dropout(nn.Module):
    """Inverted dropout in training mode (``autograd.record()``, as in the
    JAX package), or always with ``mode="always"`` (:func:`ops.Dropout`);
    the identity otherwise. `axes` share one mask along them. The mask is
    drawn from `generator`, by default the seeded generator of the input's
    device (:func:`random.generator`)."""

    def __init__(self, rate, axes=(), generator=None, mode="training"):
        super().__init__()
        self._rate = float(rate)
        self._axes = tuple(axes)
        self._generator = generator
        self._mode = mode

    def forward(self, x):
        return ops.Dropout(x, self._rate, self._mode, self._axes,
                           self._generator)


class GELU(nn.Module):
    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation != "erf"

    def forward(self, x):
        return ops.gelu(x, approximate=self._approx)


class Embedding(nn.Module):
    """Lookup table (input_dim, output_dim); ids follow
    :func:`ops.normalize_ids` (rounded, int32, clamped)."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(input_dim, output_dim))

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm needs in_channels (shapes are fixed "
                             "at construction)")
        self._axis = axis
        self._eps = epsilon
        self.gamma = nn.Parameter(torch.ones(in_channels))
        self.beta = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._eps)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 2


class Conv2D(nn.Module):
    """2-D convolution. ``layout="NHWC"`` takes channels-last input and an
    HWIO weight of ``kernel + (in_channels // groups, channels)``;
    ``"NCHW"`` an OIHW weight of ``(channels, in_channels // groups) +
    kernel``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCHW", in_channels=0,
                 use_bias=True):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("Conv2D needs in_channels (shapes are fixed at "
                             "construction)")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"unsupported Conv2D layout {layout!r}")
        k = _pair(kernel_size)
        self._stride = _pair(strides)
        self._pad = _pair(padding)
        self._dilate = _pair(dilation)
        self._groups = groups
        self._layout = layout
        shape = ((channels, in_channels // groups) + k if layout == "NCHW"
                 else k + (in_channels // groups, channels))
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(self, x):
        return ops.conv(x, self.weight, self.bias, self._stride, self._pad,
                        self._dilate, self._groups, self._layout)


class BatchNorm(nn.Module):
    """BatchNorm over `axis`. Inside ``autograd.record()`` (training mode)
    it normalizes with the batch statistics and updates ``running_mean``
    and ``running_var`` (momentum `momentum`, biased batch variance);
    otherwise it normalizes with them. ``scale=False`` fixes gamma at one,
    ``center=False`` freezes beta."""

    _act = None

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, in_channels=0):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("BatchNorm needs in_channels (shapes are fixed "
                             "at construction)")
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self.gamma = nn.Parameter(torch.ones(in_channels),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros(in_channels),
                                 requires_grad=center)
        self.register_buffer("running_mean", torch.zeros(in_channels))
        self.register_buffer("running_var", torch.ones(in_channels))

    def forward(self, x):
        training = autograd.is_training()
        y, new_mean, new_var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            axis=self._axis, eps=self._eps, momentum=self._momentum,
            training=training, fix_gamma=not self._scale, act=self._act)
        if training:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y


class BatchNormReLU(BatchNorm):
    """BatchNorm with a fused trailing ReLU: on a channels-last input the
    normalize+affine+relu tail runs as one pass of the scale/shift/act
    kernel (the batch statistics stay PyTorch reductions in training
    mode)."""

    _act = "relu"


class MaxPool2D(nn.Module):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCHW"):
        super().__init__()
        self._kernel = _pair(pool_size)
        self._stride = None if strides is None else _pair(strides)
        self._pad = _pair(padding)
        self._layout = layout

    def forward(self, x):
        return ops.pooling(x, "max", self._kernel, self._stride, self._pad,
                           layout=self._layout)


class GlobalAvgPool2D(nn.Module):
    def __init__(self, layout="NCHW"):
        super().__init__()
        self._layout = layout

    def forward(self, x):
        return ops.pooling(x, "avg", global_pool=True, layout=self._layout)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


@torch.no_grad()
def init_params(module: nn.Module, sigma=0.02, seed=0):
    """Initialize every parameter by the JAX package's name rules under
    ``init.Normal(sigma)``: ``gamma`` ones, ``beta`` and every name ending
    in ``bias`` (``mlm_bias`` too) zeros, everything else normal(0, sigma)
    from a ``torch.Generator`` seeded with `seed` (drawn on the CPU, then
    copied to the parameter's device). The buffers ``running_mean`` and
    ``running_var`` become zeros and ones."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "gamma":
            p.fill_(1.0)
        elif leaf == "beta" or leaf.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.empty(p.shape).normal_(0.0, sigma, generator=g))
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            b.zero_()
        elif leaf == "running_var":
            b.fill_(1.0)
    return module
