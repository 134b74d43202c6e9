"""Weight initializers (counterpart of ``incubator_mxnet_tpu/initializer.py``;
parity: python/mxnet/initializer.py).

Each initializer makes a tensor for a (shape, dtype) on a device, drawing
from an explicit ``torch.Generator``: by default the seeded generator of
that device (:func:`random.generator`), so ``random.seed(n)`` makes every
draw repeat. The string registry has the JAX package's names
(``create("xavier")``), and ``to_attr_str`` its JSON form. The fans follow
the JAX package's ``_fans``: ``shape[0]`` is the output, ``shape[1:]`` the
input, whatever the layout (an HWIO conv weight too).

Not ported: ``FusedRNN``, which waits for the recurrent layers (ROADMAP
A.6).
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from . import random as _random

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "create", "register"]

_REGISTRY = {}


def register(name=None):
    """Class decorator: `create` finds the class under `name` (default its
    class name), lower-cased."""
    def deco(cls):
        _REGISTRY[(name or cls.__name__).lower()] = cls
        return cls
    return deco


def create(name, *args, **kwargs):
    """The initializer registered under `name` (any case), built with the
    arguments; an ``Initializer`` passes through."""
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown initializer {name!r}. Registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](*args, **kwargs)


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Initializer:
    """Base class. Subclasses implement ``_init(shape, dtype, generator,
    device)``."""

    def to_attr_str(self):
        """``{"name": class name lower-cased, "params": public attributes}``
        as JSON, values coerced where they can be (numpy scalars and
        arrays, tuples, nested initializers); a value that cannot be
        serialised is left out."""
        def coerce(v):
            if isinstance(v, (np.floating, np.integer, np.bool_)):
                return v.item()
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (tuple, list)):
                return [coerce(e) for e in v]
            if isinstance(v, Initializer):
                return json.loads(v.to_attr_str())
            return v

        params = {}
        for k, v in vars(self).items():
            if k.startswith("_"):
                continue
            v = coerce(v)
            try:
                json.dumps(v)
            except TypeError:
                continue
            params[k] = v
        return json.dumps({"name": type(self).__name__.lower(),
                           "params": params})

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        """A new tensor of `shape` and `dtype` on `device` (default the
        CPU), drawn from `generator` (default ``random.generator(device)``;
        a generator must live on `device`)."""
        device = torch.device("cpu" if device is None else device)
        if generator is None:
            generator = _random.generator(device)
        return self._init(tuple(int(s) for s in shape), _dtype(dtype),
                          generator, device)

    def _init(self, shape, dtype, generator, device):
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


@register("zeros")
@register("zero")
class Zero(Initializer):
    def _init(self, shape, dtype, generator, device):
        return torch.zeros(shape, dtype=dtype, device=device)


@register("ones")
@register("one")
class One(Initializer):
    def _init(self, shape, dtype, generator, device):
        return torch.ones(shape, dtype=dtype, device=device)


@register()
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init(self, shape, dtype, generator, device):
        return torch.full(shape, float(self.value), dtype=dtype,
                          device=device)


def _uniform(shape, lo, hi, generator, device):
    """f32 draws in [lo, hi)."""
    return torch.empty(shape, device=device).uniform_(lo, hi,
                                                      generator=generator)


def _normal(shape, sigma, generator, device):
    """f32 draws from N(0, sigma^2)."""
    return torch.empty(shape, device=device).normal_(0.0, sigma,
                                                     generator=generator)


@register()
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init(self, shape, dtype, generator, device):
        return _uniform(shape, -self.scale, self.scale, generator,
                        device).to(dtype)


@register()
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init(self, shape, dtype, generator, device):
        return _normal(shape, self.sigma, generator, device).to(dtype)


def _fans(shape, factor_type):
    """The JAX package's fan: shape[0] is the output, shape[1:] the input
    (as the reference's Xavier reckons it); "avg", "in" or "out"."""
    hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    if factor_type == "in":
        return float(fan_in)
    if factor_type == "out":
        return float(fan_out)
    raise ValueError(f"bad factor_type {factor_type}")


@register()
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init(self, shape, dtype, generator, device):
        scale = math.sqrt(self.magnitude / _fans(shape, self.factor_type))
        if self.rnd_type == "uniform":
            out = _uniform(shape, -scale, scale, generator, device)
        elif self.rnd_type == "gaussian":
            out = _normal(shape, scale, generator, device)
        else:
            raise ValueError(f"bad rnd_type {self.rnd_type}")
        return out.to(dtype)


@register("msraprelu")
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)


@register()
class Orthogonal(Initializer):
    """`scale` times the orthonormal factor of a (shape[0], prod(shape[1:]))
    draw (uniform in [-1, 1) or normal), from its SVD."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init(self, shape, dtype, generator, device):
        nout = shape[0]
        nin = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = _uniform((nout, nin), -1.0, 1.0, generator, device)
        else:
            tmp = _normal((nout, nin), 1.0, generator, device)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        return (self.scale * q.reshape(shape)).to(dtype)


@register()
class Bilinear(Initializer):
    """Upsampling deconv weights (parity: mx.init.Bilinear)."""

    def _init(self, shape, dtype, generator, device):
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(device=device, dtype=dtype)


@register("lstmbias")
class LSTMBias(Initializer):
    """Forget-gate bias = `forget_bias` (gate order i, f, g, o), the rest
    zero."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init(self, shape, dtype, generator, device):
        b = torch.zeros(shape, dtype=dtype, device=device)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


@register()
class Mixed(Initializer):
    """Pattern-matched initializer selection by parameter name: the first
    pattern that `re.search` finds in the name picks its initializer."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def init_for(self, name):
        for pat, init in self.map:
            if pat.search(name):
                return init
        raise ValueError(f"no initializer pattern matches {name!r}")

    def _init(self, shape, dtype, generator, device):
        raise RuntimeError("Mixed must be resolved per-parameter via "
                           "init_for()")
