"""The port's ``nd.random`` on the CPU: seeding, shapes, dtypes and moments.

Draws cannot match the JAX package's bits (another generator), so each
sampler is held to the JAX package's shape and dtype for the same call
(one JAX call a case), to reproducibility under ``random.seed``, and to
its distribution's mean and variance over 20000 draws, within five
standard errors of each (a seeded draw; the bound is fixed before the
draw). Every draw takes the port's ``random.generator`` of its device:
torch's global generator is left as it was.
"""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import cpu, nd
from incubator_mxnet_tpu_torch import random as trandom

N = 20000
SIGMAS = 5.0

# name -> (call on a nd.random module, mean, variance) of the distribution
SAMPLERS = {
    "uniform": (lambda R, s: R.uniform(-1.0, 3.0, shape=s), 1.0, 16 / 12),
    "normal": (lambda R, s: R.normal(2.0, 0.5, shape=s), 2.0, 0.25),
    "randint": (lambda R, s: R.randint(2, 7, shape=s), 4.0, (25 - 1) / 12),
    "bernoulli": (lambda R, s: R.bernoulli(0.3, shape=s), 0.3, 0.21),
    "gamma": (lambda R, s: R.gamma(2.5, 1.5, shape=s), 3.75, 2.5 * 2.25),
    "gamma_small_alpha": (lambda R, s: R.gamma(0.5, 2.0, shape=s), 1.0,
                          2.0),
    "exponential": (lambda R, s: R.exponential(2.0, shape=s), 2.0, 4.0),
    "poisson": (lambda R, s: R.poisson(3.0, shape=s), 3.0, 3.0),
    "negative_binomial": (lambda R, s: R.negative_binomial(
        3, 0.4, shape=s), 3 * 0.6 / 0.4, 3 * 0.6 / 0.16),
    "truncated_normal": (lambda R, s: R.truncated_normal(
        1.0, 2.0, shape=s), 1.0, 4.0 * 0.7737413),
}


def _std_error(var, n):
    return math.sqrt(var / n)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_shape_dtype_and_moments(name):
    fn, mean, var = SAMPLERS[name]
    with mx.cpu():
        want = fn(jnd.random, (2, 3))
    trandom.seed(11)
    with cpu():
        small = fn(nd.random, (2, 3))
        big = fn(nd.random, (N,)).asnumpy().astype(np.float64)
    assert small.shape == want.shape == (2, 3)
    assert np.dtype(small.dtype) == np.dtype(want.dtype)
    assert abs(big.mean() - mean) <= SIGMAS * _std_error(var, N), \
        (name, big.mean(), mean)
    # the sample variance's standard error, from the fourth moment
    m4 = ((big - big.mean()) ** 4).mean()
    assert abs(big.var() - var) <= SIGMAS * math.sqrt(
        max(m4 - var ** 2, 1e-12) / N), (name, big.var(), var)
    if name == "truncated_normal":
        assert np.abs(big - 1.0).max() <= 4.0
    if name in ("randint", "poisson", "negative_binomial", "bernoulli"):
        assert np.array_equal(big, np.round(big))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_seed_reproduces_and_advances(name):
    fn = SAMPLERS[name][0]
    with cpu():
        trandom.seed(5)
        a = fn(nd.random, (50,)).asnumpy()
        b = fn(nd.random, (50,)).asnumpy()
        trandom.seed(5)
        again = fn(nd.random, (50,)).asnumpy()
        nd.random.seed(5)
        via_nd = fn(nd.random, (50,)).asnumpy()
    np.testing.assert_array_equal(a, again)
    np.testing.assert_array_equal(a, via_nd)
    assert not np.array_equal(a, b)


def test_dtypes_out_and_ctx():
    with cpu():
        for dt in ("float32", "float16", "float64"):
            assert nd.random.uniform(shape=(3,), dtype=dt).dtype == \
                np.dtype(dt)
        assert nd.random.normal(shape=2, dtype="bfloat16").dtype == \
            torch.bfloat16
        assert nd.random.randint(0, 4, shape=(2,), dtype="int64").dtype == \
            np.int64
        out = nd.zeros((4, 5))
        r = nd.random.uniform(2.0, 3.0, out=out)
        assert r is out and out.shape == (4, 5)
        assert (out.asnumpy() >= 2).all() and (out.asnumpy() < 3).all()
        out2 = nd.zeros((3,), dtype="float16")
        nd.random.normal(out=out2)
        assert out2.dtype == np.float16 and np.abs(out2.asnumpy()).sum() > 0
    assert nd.random.randn(2, 3, ctx=cpu()).shape == (2, 3)
    assert nd.random.uniform(shape=(2,), ctx=cpu()).context == cpu()


def test_multinomial_shuffle_permutation_against_jax_shapes():
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]], np.float32)
    with mx.cpu():
        jp = jnd.array(probs)
        want = [jnd.random.multinomial(jp), jnd.random.multinomial(jp, 4),
                jnd.random.multinomial(jp[0], 3),
                jnd.random.multinomial(jp, 2, get_prob=True)[1],
                jnd.random.permutation(7), jnd.random.shuffle(jp)]
    trandom.seed(2)
    with cpu():
        tp = nd.array(probs)
        got = [nd.random.multinomial(tp), nd.random.multinomial(tp, 4),
               nd.random.multinomial(tp[0], 3),
               nd.random.multinomial(tp, 2, get_prob=True)[1],
               nd.random.permutation(7), nd.random.shuffle(tp)]
        idx, logp = nd.random.multinomial(tp, 6, get_prob=True)
        many = nd.random.categorical(tp[0], N).asnumpy()
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.dtype(g.dtype) == np.dtype(w.dtype)
    # a category of probability 0 is never drawn; the log-probabilities
    # are those of the drawn categories
    assert not (idx.asnumpy()[1] == 1).any()
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.take_along_axis(probs, idx.asnumpy(), 1)),
        rtol=1e-6)
    freq = np.bincount(many, minlength=3) / N
    assert np.abs(freq - probs[0]).max() <= SIGMAS * math.sqrt(0.25 / N)
    assert sorted(got[4].asnumpy().tolist()) == list(range(7))
    assert sorted(map(tuple, got[5].asnumpy().tolist())) == sorted(
        map(tuple, probs.tolist()))


@pytest.mark.parametrize("name", ["sample_uniform", "sample_normal",
                                  "sample_exponential", "sample_poisson",
                                  "sample_gamma"])
def test_sample_family_against_jax_shapes_and_moments(name):
    p1 = np.array([1.0, 3.0], np.float32)
    p2 = np.array([2.0, 5.0], np.float32)
    args = {"sample_uniform": (p1, p2), "sample_normal": (p1, p2 / 4),
            "sample_exponential": (p1,), "sample_poisson": (p2,),
            "sample_gamma": (p2, p1)}[name]
    with mx.cpu():
        want = getattr(jnd.random, name)(*[jnd.array(a) for a in args],
                                         shape=(3, 2))
    trandom.seed(3)
    with cpu():
        got = getattr(nd.random, name)(*[nd.array(a) for a in args],
                                       shape=(3, 2))
        big = getattr(nd, name)(*[nd.array(a) for a in args],
                                shape=N).asnumpy().astype(np.float64)
    assert got.shape == want.shape == (2, 3, 2)
    assert np.dtype(got.dtype) == np.dtype(want.dtype)
    a, b = (list(args) + [None])[:2]
    mean, var = {
        "sample_uniform": lambda: ((a + b) / 2, (b - a) ** 2 / 12),
        "sample_normal": lambda: (a, b ** 2),
        "sample_exponential": lambda: (1 / a, 1 / a ** 2),
        "sample_poisson": lambda: (a, a),
        "sample_gamma": lambda: (a * b, a * b ** 2),
    }[name]()
    for row in range(2):
        err = abs(big[row].mean() - mean[row])
        assert err <= SIGMAS * math.sqrt(var[row] / N), (name, row, err)


def test_draws_leave_torchs_global_generator_alone():
    state = torch.get_rng_state()
    with cpu():
        for fn, _, _ in SAMPLERS.values():
            fn(nd.random, (8,))
        nd.random.shuffle(nd.arange(5))
    assert torch.equal(torch.get_rng_state(), state)


def test_mx_random_is_the_sampler_module_too():
    for name in ("uniform", "normal", "randint", "multinomial", "shuffle",
                 "sample_gamma", "seed"):
        assert getattr(trandom, name) is not None
        assert hasattr(jnd.random, name)
    assert trandom.uniform is nd.random.uniform
    trandom.seed(9)
    a = trandom.uniform(shape=(4,), ctx=cpu()).asnumpy()
    trandom.seed(9)
    np.testing.assert_array_equal(
        a, nd.random.uniform(shape=(4,), ctx=cpu()).asnumpy())
