"""Random sampling on NDArrays (counterpart of
``incubator_mxnet_tpu/ndarray/random.py``; parity: mx.nd.random).

Every draw takes the seeded generator of its device from the port's
``random.generator`` (one ``torch.Generator`` a device, reseeded by
``random.seed``), never torch's global RNG. The draws cannot match the JAX
package's bits (another generator): what holds across the two packages is
the shape, the dtype, the distribution, and reproducibility under
``seed``. An array lands on `ctx`, by default the current context
(``with cpu():`` or ``ctx=cpu()`` on a machine without a card).

The gamma draws (``gamma``, ``negative_binomial``, ``sample_gamma``) use
Marsaglia and Tsang's rejection method on the generator's normals and
uniforms, because torch's own gamma sampler takes no generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import random as _rng
from ..context import as_context
from . import NDArray, _torch_dtype, _unwrap, _wrap

__all__ = ["seed", "uniform", "normal", "randn", "randint", "bernoulli",
           "gamma", "exponential", "poisson", "negative_binomial",
           "multinomial", "categorical", "shuffle", "permutation",
           "truncated_normal", "sample_uniform", "sample_normal",
           "sample_exponential", "sample_poisson", "sample_gamma"]


def seed(seed_state, ctx="all"):
    """Seed every generator the port draws from (``random.seed``)."""
    _rng.seed(seed_state, ctx)


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dev(ctx, out=None):
    if out is not None:
        return out._data.device
    return as_context(ctx).device


def _empty(shape, dtype, device):
    return torch.empty(_shape(shape), dtype=_torch_dtype(dtype),
                       device=device)


def _result(r, out):
    """`r` as a new NDArray, or written into `out` (in its dtype)."""
    if out is not None:
        return out._set(r.to(out._data.dtype))
    return _wrap(r)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    if out is not None and shape is None:
        shape = out.shape
    dev = _dev(ctx, out)
    r = _empty(shape, dtype, dev).uniform_(low, high,
                                           generator=_rng.generator(dev))
    return _result(r, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    if out is not None and shape is None:
        shape = out.shape
    dev = _dev(ctx, out)
    r = _empty(shape, dtype, dev).normal_(loc, scale,
                                          generator=_rng.generator(dev))
    return _result(r, out)


def randn(*shape, **kw):
    return normal(shape=shape, **kw)


def randint(low, high=None, shape=None, dtype="int32", ctx=None):
    if high is None:
        low, high = 0, low
    dev = _dev(ctx)
    return _wrap(torch.randint(int(low), int(high), _shape(shape),
                               generator=_rng.generator(dev),
                               dtype=_torch_dtype(dtype), device=dev))


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    p = torch.full(_shape(shape), float(prob), device=dev)
    return _wrap(torch.bernoulli(p, generator=_rng.generator(dev)).to(
        _torch_dtype(dtype)))


def _std_gamma(alpha, gen):
    """Gamma(alpha, 1) draws of the shape of tensor `alpha` (f32 or f64):
    Marsaglia and Tsang's method, alpha < 1 boosted by u ** (1 / alpha)."""
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.empty_like(a).normal_(generator=gen)
        u = torch.empty_like(a).uniform_(generator=gen)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.empty_like(a).uniform_(generator=gen)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def _work_dtype(dt):
    return dt if dt in (torch.float32, torch.float64) else torch.float32


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    dt = _torch_dtype(dtype)
    a = torch.full(_shape(shape), float(alpha), dtype=_work_dtype(dt),
                   device=dev)
    return _wrap((_std_gamma(a, _rng.generator(dev)) * beta).to(dt))


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    r = _empty(shape, dtype, dev).exponential_(
        generator=_rng.generator(dev)) * scale
    return _wrap(r)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    rates = torch.full(_shape(shape), float(lam), device=dev)
    return _wrap(torch.poisson(rates, generator=_rng.generator(dev)).to(
        _torch_dtype(dtype)))


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    gen = _rng.generator(dev)
    a = torch.full(_shape(shape), float(k), device=dev)
    rates = _std_gamma(a, gen) * (1 - p) / p
    return _wrap(torch.poisson(rates, generator=gen).to(_torch_dtype(dtype)))


def multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Category indices drawn from (batched) probability rows `data`;
    with `get_prob`, also the log-probability of each draw."""
    n = shape if isinstance(shape, int) else int(np.prod(shape))
    p = _unwrap(data).detach().float()
    gen = _rng.generator(p.device)
    idx = torch.multinomial(p.reshape(-1, p.shape[-1]), n, replacement=True,
                            generator=gen)
    logp = torch.log(torch.clamp(p, 1e-20)).reshape(-1, p.shape[-1])
    sample_logp = torch.gather(logp, 1, idx)
    if p.ndim == 1:
        idx, sample_logp = idx[0], sample_logp[0]
    if n == 1:
        idx, sample_logp = idx[..., 0], sample_logp[..., 0]
    out = _wrap(idx.to(_torch_dtype(dtype)))
    if get_prob:
        return out, _wrap(sample_logp)
    return out


categorical = multinomial


def shuffle(data):
    """`data` with its first axis in a random order."""
    t = _unwrap(data)
    perm = torch.randperm(t.shape[0], generator=_rng.generator(t.device),
                          device=t.device)
    return _wrap(t.detach().index_select(0, perm))


def permutation(n, ctx=None):
    dev = _dev(ctx)
    return _wrap(torch.randperm(int(n), generator=_rng.generator(dev),
                                device=dev).to(torch.int32))


def truncated_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                     ctx=None):
    """Normal draws cut at two standard deviations (the JAX package's
    bounds), by the inverse CDF of uniforms between them."""
    dev = _dev(ctx)
    dt = _torch_dtype(dtype)
    lo = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(_shape(shape), dtype=_work_dtype(dt), device=dev)
    u.uniform_(lo, 1 - lo, generator=_rng.generator(dev))
    z = math.sqrt(2.0) * torch.erfinv(2 * u - 1)
    return _wrap((loc + scale * z.clamp(-2.0, 2.0)).to(dt))


# ---------------------------------------------------------------------------
# sample_* family: per-element distribution parameters (parity:
# mx.nd.sample_uniform/...). Each parameter array contributes one output
# row of `shape` draws.
# ---------------------------------------------------------------------------

def _param(p, dt, ctx):
    if isinstance(p, NDArray):
        return p._data.detach().to(dt)
    if isinstance(p, torch.Tensor):
        return p.detach().to(dt)
    return torch.as_tensor(np.asarray(p), dtype=dt, device=_dev(ctx))


def _bcast(p, extra):
    """Parameter array -> shape broadcastable against (p.shape + extra)."""
    return p.reshape(p.shape + (1,) * len(extra))


def sample_uniform(low, high, shape=None, dtype="float32", ctx=None):
    dt = _torch_dtype(dtype)
    low, high = _param(low, dt, ctx), _param(high, dt, ctx)
    extra = _shape(shape)
    r = torch.empty(low.shape + extra, dtype=dt, device=low.device)
    r.uniform_(generator=_rng.generator(low.device))
    return _wrap(_bcast(low, extra) + r * _bcast(high - low, extra))


def sample_normal(mu, sigma, shape=None, dtype="float32", ctx=None):
    dt = _torch_dtype(dtype)
    mu, sigma = _param(mu, dt, ctx), _param(sigma, dt, ctx)
    extra = _shape(shape)
    r = torch.empty(mu.shape + extra, dtype=dt, device=mu.device)
    r.normal_(generator=_rng.generator(mu.device))
    return _wrap(_bcast(mu, extra) + r * _bcast(sigma, extra))


def sample_exponential(lam, shape=None, dtype="float32", ctx=None):
    dt = _torch_dtype(dtype)
    lam = _param(lam, dt, ctx)
    extra = _shape(shape)
    r = torch.empty(lam.shape + extra, dtype=dt, device=lam.device)
    r.exponential_(generator=_rng.generator(lam.device))
    return _wrap(r / _bcast(lam, extra))


def sample_poisson(lam, shape=None, dtype="float32", ctx=None):
    lam = _param(lam, torch.float32, ctx)
    extra = _shape(shape)
    rates = torch.broadcast_to(_bcast(lam, extra), lam.shape + extra)
    r = torch.poisson(rates.contiguous(),
                      generator=_rng.generator(lam.device))
    return _wrap(r.to(_torch_dtype(dtype)))


def sample_gamma(alpha, beta, shape=None, dtype="float32", ctx=None):
    dt = _torch_dtype(dtype)
    alpha, beta = _param(alpha, dt, ctx), _param(beta, dt, ctx)
    extra = _shape(shape)
    a = torch.broadcast_to(_bcast(alpha, extra), alpha.shape + extra)
    r = _std_gamma(a.to(_work_dtype(dt)), _rng.generator(alpha.device))
    return _wrap((r * _bcast(beta, extra)).to(dt))
