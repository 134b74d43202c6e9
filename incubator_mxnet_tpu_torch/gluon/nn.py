"""Layers as ``torch.nn.Module``s: the subset of
``incubator_mxnet_tpu/gluon/nn/__init__.py`` that BERT and the causal LM
need.

Parameter names and shapes follow the JAX package (Dense ``weight`` is
(units, in_units); LayerNorm has ``gamma`` and ``beta``), so a module's
``state_dict`` keys are the JAX side's structural names. Shapes are given
at construction: there is no deferred shape inference. Parameters start
deterministic (weights and biases zero, gamma one); :func:`init_params`
draws the weights from a seeded generator.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import autograd, ops

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout", "GELU",
           "Embedding", "LayerNorm", "init_params"]


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
    JAX package), the identity otherwise."""

    def __init__(self, rate, generator=None):
        super().__init__()
        self._rate = float(rate)
        self._generator = generator

    def forward(self, x):
        return ops.dropout(x, self._rate, autograd.is_training(),
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


@torch.no_grad()
def init_params(module: nn.Module, sigma=0.02, seed=0):
    """Initialize every parameter by the JAX package's name rules under
    ``init.Normal(sigma)``: ``gamma`` ones, ``beta`` and ``bias`` zeros,
    everything else normal(0, sigma) from a ``torch.Generator`` seeded with
    `seed` (drawn on the CPU, then copied to the parameter's device)."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "gamma":
            p.fill_(1.0)
        elif leaf in ("beta", "bias"):
            p.zero_()
        else:
            p.copy_(torch.empty(p.shape).normal_(0.0, sigma, generator=g))
    return module
