"""Layers, each a :class:`~.block.HybridBlock`: the subset of
``incubator_mxnet_tpu/gluon/nn/__init__.py`` that BERT, the causal LM and
ResNet need.

Parameter names, shapes and initializers follow the JAX package (Dense
``weight`` is (units, in_units); an NHWC Conv2D ``weight`` is kernel +
(in_channels, channels); LayerNorm and BatchNorm have ``gamma`` (ones) and
``beta`` (zeros); biases zeros), so a module's ``state_dict`` keys are the
JAX side's structural names and ``collect_params()`` its full names.
BatchNorm's ``running_mean`` and ``running_var`` are buffers, listed by
``collect_params`` with ``grad_req="null"`` as the JAX side lists them.

The sizes the JAX layer can infer (``in_units=0``, ``in_channels=0``) are
completed by the layer's first call (``infer_shape``); given explicitly,
the parameters exist from construction, at their layers' starting values
(weights zero until ``initialize`` or :func:`init_params` draws them).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd, ops
from .block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout", "GELU",
           "Embedding", "LayerNorm", "Conv2D", "BatchNorm", "BatchNormReLU",
           "MaxPool2D", "GlobalAvgPool2D", "Flatten", "init_params"]


class HybridSequential(HybridBlock):
    """Children named "0", "1", ... in the order added; the first takes
    every argument, the rest the previous output."""

    def __init__(self, *blocks, prefix=None, params=None):
        super().__init__(prefix, params)
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x, *args):
        for child in self._modules.values():
            x = child(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        vals = list(self._modules.values())
        if isinstance(idx, slice):
            return HybridSequential(*vals[idx])
        return vals[idx]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """FullyConnected layer; weight (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self.act = activation
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      dtype=dtype, init=weight_initializer)
        self.bias = (self.params.get("bias", shape=(units,), dtype=dtype,
                                     init=bias_initializer)
                     if use_bias else None)

    def infer_shape(self, x, *args):
        in_units = (int(np.prod(x.shape[1:])) if self._flatten
                    else x.shape[-1])
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias, self._flatten)
        if self.act:
            out = ops.activation(out, self.act)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act = activation

    def forward(self, x):
        return ops.activation(x, self._act)


class Dropout(HybridBlock):
    """Inverted dropout in training mode (``autograd.record()``, as in the
    JAX package), or always with ``mode="always"`` (:func:`ops.Dropout`);
    the identity otherwise. `axes` share one mask along them. The mask is
    drawn from `generator`, by default the seeded generator of the input's
    device (:func:`random.generator`)."""

    def __init__(self, rate, axes=(), generator=None, mode="training",
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = float(rate)
        self._axes = tuple(axes)
        self._generator = generator
        self._mode = mode

    def forward(self, x):
        return ops.Dropout(x, self._rate, self._mode, self._axes,
                           self._generator)


class GELU(HybridBlock):
    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix, params)
        self._approx = approximation != "erf"

    def forward(self, x):
        return ops.gelu(x, approximate=self._approx)


class Embedding(HybridBlock):
    """Lookup table (input_dim, output_dim); ids follow
    :func:`ops.normalize_ids`: rounded to int32, and an id outside
    ``[0, input_dim)`` clamped (``oor_policy="clip"``) or, on a call that
    is not being captured, refused with ``ValueError``
    (``oor_policy="error"``). ``sparse_grad=True`` (a row-sparse weight
    gradient) raises: ``nd.sparse`` is not ported (ROADMAP A.5c)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False,
                 oor_policy="clip", prefix=None, params=None):
        super().__init__(prefix, params)
        if sparse_grad:
            raise NotImplementedError(
                "Embedding(sparse_grad=True) makes a row-sparse gradient; "
                "nd.sparse is not ported yet (ROADMAP A.5c)")
        if oor_policy not in ops.OOR_POLICIES:
            raise ValueError(f"oor_policy must be one of "
                             f"{ops.OOR_POLICIES}, got {oor_policy!r}")
        self._oor_policy = oor_policy
        self.weight = self.params.get("weight",
                                      shape=(input_dim, output_dim),
                                      dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return ops.embedding(x, self.weight, self._oor_policy)


def _norm_params(block, in_channels, center, scale, beta_initializer,
                 gamma_initializer):
    block.gamma = block.params.get("gamma", shape=(in_channels,),
                                   init=gamma_initializer,
                                   grad_req="write" if scale else "null")
    block.beta = block.params.get("beta", shape=(in_channels,),
                                  init=beta_initializer,
                                  grad_req="write" if center else "null")


class LayerNorm(HybridBlock):
    """Layer norm over `axis`; ``center=False`` freezes beta and
    ``scale=False`` gamma (``grad_req="null"``), as in the JAX package."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._eps = epsilon
        _norm_params(self, in_channels, center, scale, beta_initializer,
                     gamma_initializer)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (c,)

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._eps)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 2


class Conv2D(HybridBlock):
    """2-D convolution. ``layout="NHWC"`` takes channels-last input and an
    HWIO weight of ``kernel + (in_channels // groups, channels)``;
    ``"NCHW"`` an OIHW weight of ``(channels, in_channels // groups) +
    kernel``. `activation` names an activation applied to the output."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"unsupported Conv2D layout {layout!r}")
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._stride = _pair(strides)
        self._pad = _pair(padding)
        self._dilate = _pair(dilation)
        self._groups = groups
        self._layout = layout
        self.act = activation
        self.weight = self.params.get("weight",
                                      shape=self._weight_shape(in_channels),
                                      init=weight_initializer)
        self.bias = (self.params.get("bias", shape=(channels,),
                                     init=bias_initializer)
                     if use_bias else None)

    def _weight_shape(self, in_channels):
        cin = in_channels // self._groups if in_channels else 0
        if self._layout == "NCHW":
            return (self._channels, cin) + self._kernel
        return self._kernel + (cin, self._channels)

    def infer_shape(self, x, *args):
        c = x.shape[1 if self._layout == "NCHW" else x.ndim - 1]
        self._reg_params["weight"].shape = self._weight_shape(c)

    def forward(self, x):
        out = ops.conv(x, self.weight, self.bias, self._stride, self._pad,
                       self._dilate, self._groups, self._layout)
        if self.act:
            out = ops.activation(out, self.act)
        return out


class BatchNorm(HybridBlock):
    """BatchNorm over `axis`. Inside ``autograd.record()`` (training mode)
    it normalizes with the batch statistics and updates ``running_mean``
    and ``running_var`` (momentum `momentum`, biased batch variance);
    otherwise it normalizes with them. ``scale=False`` fixes gamma at one,
    ``center=False`` freezes beta."""

    _act = None

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        _norm_params(self, in_channels, center, scale, beta_initializer,
                     gamma_initializer)
        self.running_mean = self.params.get(
            "running_mean", shape=(in_channels,),
            init=running_mean_initializer, grad_req="null", buffer=True)
        self.running_var = self.params.get(
            "running_var", shape=(in_channels,),
            init=running_variance_initializer, grad_req="null", buffer=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self._reg_params[name].shape = (c,)

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


class MaxPool2D(HybridBlock):
    """Max pooling with MXNet's padding; ``ceil_mode`` keeps the last
    partial window. `count_include_pad` is taken as the JAX layer takes it:
    it changes only average pooling, so nothing here."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCHW",
                 count_include_pad=True, ceil_mode=False, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._kernel = _pair(pool_size)
        self._stride = None if strides is None else _pair(strides)
        self._pad = _pair(padding)
        self._layout = layout
        self._ceil = ceil_mode

    def forward(self, x):
        return ops.pooling(x, "max", self._kernel, self._stride, self._pad,
                           layout=self._layout, ceil_mode=self._ceil)


class GlobalAvgPool2D(HybridBlock):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__(prefix, params)
        self._layout = layout

    def forward(self, x):
        return ops.pooling(x, "avg", global_pool=True, layout=self._layout)


class Flatten(HybridBlock):
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
