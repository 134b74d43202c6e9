"""Seeded random streams (counterpart of ``incubator_mxnet_tpu/ndarray/
random.py``'s ``seed`` and key chain).

The JAX package threads one key chain through every draw; the port keeps
one ``torch.Generator`` per device instead, and every draw of the port
(dropout, SGLD's noise) takes the generator of its tensor's device from
:func:`generator`. Nothing of the port draws from torch's global RNG.

- :func:`seed` seeds every device's generator (``ctx="all"``) or one
  device's, and Python's and numpy's global generators, which host-side
  code draws from, as the JAX package's ``seed`` does.
- A generator is made on its device's first use, from the last seed given
  to every device, or from ``DEFAULT_SEED`` before any.
- The samplers of ``nd.random`` (``uniform``, ``normal``, ``randint``,
  ...) are this module's too, as ``mx.random`` is the JAX package's
  sampler module.
- :func:`using` lends a generator of one's own to a scope: inside it, on
  that thread, :func:`generator` of the generator's device returns it.
  ``FrozenModel`` runs its forward so, with a generator it resets to its
  seed before every call, as the JAX ``FrozenModel`` passes the fixed
  ``PRNGKey(0)``: a draw in a frozen forward (dropout with
  ``mode="always"``) gives one mask, call after call, and leaves the
  device's own generator untouched.

A CUDA generator stays right inside a captured CUDA graph: the fused step
registers it with every graph it captures, so each replay draws afresh
from the generator's offset and advances it, and a :func:`seed` after the
capture re-seeds what the next replays draw.
"""
from __future__ import annotations

import contextlib
import random as _pyrandom
import threading

import numpy as np
import torch

from .context import Context

__all__ = ["seed", "generator", "using", "DEFAULT_SEED"]

DEFAULT_SEED = 0

_lock = threading.Lock()
_generators: dict = {}      # torch.device -> torch.Generator
_seed_all = None            # the last seed given with ctx="all"
_lent = threading.local()   # .gen: the generator lent by `using`, or None


def _device(device) -> torch.device:
    """`device` (a ``torch.device``, its name, or a ``Context``) with the
    current CUDA index filled in for a bare ``"cuda"``."""
    if isinstance(device, Context):
        return device.device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device) -> torch.Generator:
    """The generator every draw on `device` takes: made on first use, seeded
    by the last ``seed(n)`` given to every device (``DEFAULT_SEED`` before
    any); inside :func:`using`, on its thread, the lent generator where it
    lies on `device`."""
    device = _device(device)
    lent = getattr(_lent, "gen", None)
    if lent is not None and _device(lent.device) == device:
        return lent
    with _lock:
        g = _generators.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(DEFAULT_SEED if _seed_all is None else _seed_all)
            _generators[device] = g
        return g


@contextlib.contextmanager
def using(gen: torch.Generator):
    """Inside, on this thread, :func:`generator` of `gen`'s device returns
    `gen` (the device's own generator is not drawn from, nor changed);
    nested scopes restore the one outside on exit."""
    outer = getattr(_lent, "gen", None)
    _lent.gen = gen
    try:
        yield gen
    finally:
        _lent.gen = outer


def seed(seed_state, ctx="all"):
    """Seed the generators: every device's, the ones made later included,
    for ``ctx="all"``, else only the generator of `ctx` (a ``Context`` or a
    device). Python's and numpy's global generators are seeded too, as the
    JAX package's ``seed`` does, so one call makes host-side randomness and
    the device draws reproducible together."""
    global _seed_all
    n = int(seed_state)
    if isinstance(ctx, str) and ctx == "all":
        with _lock:
            _seed_all = n
            for g in _generators.values():
                g.manual_seed(n)
    else:
        generator(ctx).manual_seed(n)
    _pyrandom.seed(n)
    np.random.seed(n % (2 ** 32))


# mx.random is the sampler module as well (ndarray.random draws from
# generator() above, which is defined by the time this import runs)
from .ndarray.random import (bernoulli, categorical, exponential,  # noqa: E402,F401
                             gamma, multinomial, negative_binomial, normal,
                             permutation, poisson, randint, randn,
                             sample_exponential, sample_gamma,
                             sample_normal, sample_poisson, sample_uniform,
                             shuffle, truncated_normal, uniform)
