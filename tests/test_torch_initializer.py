"""The port's initializers against the JAX package's.

Deterministic initializers must give the JAX package's arrays exactly; the
random ones draw from other generators, so they are held to their bounds
and moments (at 1e-2) on large draws, and ``Orthogonal`` to
orthogonality. ``_fans`` is the JAX package's, on Dense, OIHW and HWIO
shapes alike.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import random as trandom

SHAPES = [(10, 7), (64, 3, 7, 7), (7, 7, 3, 64), (1, 1, 256, 64), (5,)]


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("shape", SHAPES, ids=["dense", "oihw", "hwio",
                                               "hwio_1x1", "vector"])
def test_fans_equal_the_jax_packages(shape, factor_type):
    assert tinit._fans(shape, factor_type) == jinit._fans(shape, factor_type)


@pytest.mark.parametrize("name,args,shape", [
    ("Zero", (), (3, 4)), ("One", (), (2, 5)), ("Constant", (0.375,), (4,)),
    ("Bilinear", (), (2, 3, 4, 4)), ("Bilinear", (), (1, 1, 5, 3)),
    ("LSTMBias", (), (16,)), ("LSTMBias", (2.5,), (24,))])
def test_deterministic_initializers_equal_the_jax_packages(name, args, shape):
    got = getattr(tinit, name)(*args)(shape, "float32")
    want = np.asarray(getattr(jinit, name)(*args)(jax.random.PRNGKey(0),
                                                  shape, "float32"))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def _draw(init, shape=(256, 64, 3, 3), seed=0):
    return init(shape, "float32",
                torch.Generator().manual_seed(seed)).double().numpy()


def _close(got, want, what):
    assert abs(got - want) <= 1e-2 * abs(want), (what, got, want)


def test_uniform_and_normal_within_their_bounds_and_moments():
    u = _draw(tinit.Uniform(0.2))
    assert u.min() >= -0.2 and u.max() < 0.2
    _close(u.std(), 0.2 / math.sqrt(3), "uniform std")
    assert abs(u.mean()) <= 1e-2 * 0.2
    n = _draw(tinit.Normal(0.05))
    _close(n.std(), 0.05, "normal std")
    assert abs(n.mean()) <= 1e-2 * 0.05


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("shape", [(256, 64, 3, 3), (3, 3, 64, 256),
                                   (512, 300)])
def test_xavier_draws_the_jax_packages_scale(shape, factor_type, rnd_type):
    init = tinit.Xavier(rnd_type, factor_type, magnitude=2)
    w = _draw(init, shape)
    scale = math.sqrt(2 / jinit._fans(shape, factor_type))
    if rnd_type == "uniform":
        assert np.abs(w).max() <= scale
        _close(w.std(), scale / math.sqrt(3), "xavier uniform std")
    else:
        _close(w.std(), scale, "xavier gaussian std")
    assert abs(w.mean()) <= 1e-2 * scale


def test_msra_prelu_is_xavier_gaussian_with_the_slope_magnitude():
    init = tinit.MSRAPrelu("in", slope=0.25)
    assert (init.rnd_type, init.factor_type) == ("gaussian", "in")
    assert init.magnitude == jinit.MSRAPrelu("in", 0.25).magnitude
    assert (json.loads(init.to_attr_str())
            == json.loads(jinit.MSRAPrelu("in", 0.25).to_attr_str()))
    w = _draw(init)
    _close(w.std(), math.sqrt(init.magnitude / (64 * 9)), "msra std")


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(64, 128), (128, 64), (32, 8, 3, 3)])
def test_orthogonal_is_orthogonal(shape, rand_type):
    w = _draw(tinit.Orthogonal(scale=1.5, rand_type=rand_type), shape)
    w = w.reshape(shape[0], -1) / 1.5
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)


def test_mixed_routes_by_name_and_raises_on_no_match():
    mixed = tinit.Mixed([".*bias", ".*"], [tinit.Zero(), tinit.One()])
    jmixed = jinit.Mixed([".*bias", ".*"], [jinit.Zero(), jinit.One()])
    for name in ("dense_0bias", "dense_0weight", "conv_bias_x"):
        assert (type(mixed.init_for(name)).__name__
                == type(jmixed.init_for(name)).__name__)
    with pytest.raises(ValueError, match="no initializer pattern"):
        tinit.Mixed(["^a$"], [tinit.Zero()]).init_for("b")


@pytest.mark.parametrize("init", [
    ("xavier", dict(rnd_type="gaussian", factor_type="in", magnitude=2)),
    ("uniform", dict(scale=0.3)), ("normal", dict(sigma=0.02)),
    ("constant", dict(value=1.5)), ("orthogonal", dict(scale=2.0)),
    ("lstmbias", dict(forget_bias=0.5)), ("zeros", {})])
def test_create_and_to_attr_str_round_trip_as_in_jax(init):
    name, kw = init
    t, j = tinit.create(name, **kw), jinit.create(name, **kw)
    assert json.loads(t.to_attr_str()) == json.loads(j.to_attr_str())
    spec = json.loads(t.to_attr_str())
    again = tinit.create(spec["name"], **spec["params"])
    assert type(again) is type(t) and vars(again) == vars(t)
    assert tinit.create(t) is t


def test_draws_come_from_the_seeded_generator_of_the_device():
    trandom.seed(11)
    a = tinit.Normal(1.0)((100,))
    b = tinit.Normal(1.0)((100,))
    trandom.seed(11)
    assert torch.equal(tinit.Normal(1.0)((100,)), a)
    assert not torch.equal(a, b)
