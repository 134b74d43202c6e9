"""The port's Gluon Parameter and ParameterDict against the JAX package's:
deferred shapes, initializer precedence, ``set_data`` completing a shape,
``grad_req`` write/add/null against the JAX package's gradients on the
same numpy inputs, and the ``nd.save`` file read both ways."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, init
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.parameter import (
    DeferredInitializationError, Parameter, ParameterDict)


def test_deferred_shape_waits_for_the_first_call():
    d = nn.Dense(4)
    w = d.collect_params()[d.prefix + "weight"]
    assert w.shape == (4, 0) and not w.shape_is_known
    d.initialize(init.One(), ctx=cpu())
    with pytest.raises(DeferredInitializationError, match="deferred"):
        w.data()
    out = d(torch.ones(2, 3, 5))
    assert w.shape == (4, 15) and d.weight.shape == (4, 15)
    assert torch.equal(d.weight, torch.ones(4, 15))
    assert out.shape == (2, 4)


def test_a_call_before_initialize_names_the_fix():
    with pytest.raises(RuntimeError, match=r"initialize\(\)"):
        nn.Dense(4)(torch.ones(2, 3))


def test_explicit_shapes_exist_from_construction():
    d = nn.Dense(4, in_units=3)
    assert d.weight.shape == (4, 3) and torch.equal(d.weight,
                                                    torch.zeros(4, 3))
    bn = nn.BatchNorm(in_channels=5)
    assert torch.equal(bn.gamma, torch.ones(5))
    assert torch.equal(bn.running_var, torch.ones(5))


def test_a_parameters_own_initializer_wins():
    """As the JAX package: the layer's own init (gamma ones, bias zeros,
    weight_initializer) over ``initialize``'s, over the default."""
    d = nn.Dense(3, in_units=2, weight_initializer=init.Constant(0.5),
                 bias_initializer="ones")
    d.initialize(init.Constant(7.0), ctx=cpu())
    assert torch.equal(d.weight, torch.full((3, 2), 0.5))
    assert torch.equal(d.bias, torch.ones(3))
    bn = nn.BatchNorm(axis=-1)
    bn.initialize(init.Constant(3.0), ctx=cpu())
    bn(torch.randn(4, 6))
    for name, want in (("gamma", 1.0), ("beta", 0.0), ("running_mean", 0.0),
                       ("running_var", 1.0)):
        assert torch.equal(getattr(bn, name), torch.full((6,), want)), name
    # an initialized parameter is left alone unless forced
    d.initialize(init.Zero(), ctx=cpu())
    assert torch.equal(d.bias, torch.ones(3))
    d.collect_params().initialize(init.Zero(), ctx=cpu(), force_reinit=True)
    assert torch.equal(d.bias, torch.ones(3))     # its own init again
    # on a Parameter itself, as in the JAX package: the `init` it is handed,
    # then its own, then the default
    p = Parameter("p", shape=(2,), init=init.Constant(5.0))
    p.initialize(init=init.Constant(2.0), ctx=cpu(),
                 default_init=init.Constant(9.0))
    assert torch.equal(p.data().torch(), torch.full((2,), 2.0))
    p.initialize(ctx=cpu(), default_init=init.Constant(9.0),
                 force_reinit=True)
    assert torch.equal(p.data().torch(), torch.full((2,), 5.0))


def test_set_data_completes_a_deferred_shape_and_keeps_storage():
    d = nn.Dense(2)
    w = np.arange(10, dtype=np.float32).reshape(2, 5)
    d.collect_params()[d.prefix + "weight"].set_data(w)
    d.collect_params()[d.prefix + "bias"].set_data(np.ones(2, np.float32))
    assert d.weight.shape == (2, 5)
    out = d(torch.ones(1, 5))
    np.testing.assert_allclose(out.detach().numpy(), [[11.0, 36.0]])
    ptr = d.weight.data_ptr()
    d.collect_params()[d.prefix + "weight"].set_data(np.zeros((2, 5)))
    assert d.weight.data_ptr() == ptr
    assert float(d.weight.detach().abs().sum()) == 0
    with pytest.raises(ValueError, match="set_data of shape"):
        d.collect_params()[d.prefix + "weight"].set_data(np.zeros((3, 5)))


def test_lr_and_wd_mult_and_grad_req_reach_the_tensor():
    d = nn.Dense(2, in_units=3)
    params = d.collect_params()
    params.setattr("lr_mult", 0.5)
    params[d.prefix + "bias"].wd_mult = 0.0
    assert d.weight.lr_mult == 0.5 and d.bias.wd_mult == 0.0
    params[d.prefix + "bias"].grad_req = "null"
    assert not d.bias.requires_grad and d.bias.grad_req == "null"
    with pytest.raises(ValueError, match="grad_req"):
        params[d.prefix + "bias"].grad_req = "sum"


def _pair(req, seed=0):
    """A Dense(3, in_units=4) in both packages, grad_req `req` set before
    initialize, the same weights."""
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    jd = jnn.Dense(3, in_units=4)
    jd.collect_params().setattr("grad_req", req)
    jd.initialize()
    jd.weight.set_data(nd.array(w))
    jd.bias.set_data(nd.array(b))
    td = nn.Dense(3, in_units=4)
    td.collect_params().setattr("grad_req", req)
    td.initialize(ctx=cpu())
    tp = td.collect_params()
    tp[td.prefix + "weight"].set_data(w)
    tp[td.prefix + "bias"].set_data(b)
    return jd, td


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_matches_jax_over_two_backwards(req):
    jd, td = _pair(req)
    xs = np.random.RandomState(5).randn(2, 6, 4).astype(np.float32)
    for x in xs:
        with jautograd.record():
            jl = (jd(nd.array(x)) ** 2).sum()
        jl.backward()
        with autograd.record():
            tl = (td(torch.from_numpy(x)) ** 2).sum()
        autograd.backward(tl)
    np.testing.assert_allclose(td.weight.grad.numpy(),
                               jd.weight.grad().asnumpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(td.bias.grad.numpy(),
                               jd.bias.grad().asnumpy(), rtol=1e-5, atol=1e-5)
    if req == "add":
        td.collect_params().zero_grad()
        assert float(td.weight.grad.abs().sum()) == 0.0


def test_grad_req_null_takes_no_gradient_in_either_package():
    jd, td = _pair("null")
    x = np.ones((2, 4), np.float32)
    with autograd.record():
        out = td(torch.from_numpy(x)).sum()
    assert not out.requires_grad
    assert td.weight.grad is None
    with pytest.raises(RuntimeError, match="no gradient"):
        td.collect_params()[td.prefix + "weight"].grad()
    with pytest.raises(RuntimeError, match="no gradient"):
        jd.weight.grad()


def test_trainer_keeps_an_add_gradient_and_skips_null():
    d = nn.Dense(2, in_units=3)
    d.initialize(init.One(), ctx=cpu())
    params = d.collect_params()
    params[d.prefix + "bias"].grad_req = "null"
    params[d.prefix + "weight"].grad_req = "add"
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    assert trainer._params == [d.weight]
    with autograd.record():
        loss = d(torch.ones(1, 3)).sum()
    autograd.backward(loss)
    trainer.step(1)
    assert d.weight.grad is not None
    np.testing.assert_allclose(d.weight.detach().numpy(), 0.9, rtol=1e-6)


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {"a_weight": rng.randn(3, 4).astype(np.float32),
            "a_bias": rng.randn(3).astype(np.float32)}


def test_parameter_dict_file_reads_both_ways(tmp_path):
    arrays = _arrays(1)
    # the port writes, JAX reads
    pd = ParameterDict("a_")
    for k, v in arrays.items():
        pd.get(k[2:], shape=v.shape).set_data(v)
    pd.save(str(tmp_path / "port.params"))
    got = nd.load(str(tmp_path / "port.params"))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
    # JAX writes, the port reads (shapes deferred: set_data completes them)
    nd.save(str(tmp_path / "jax.params"),
            {k: nd.array(v + 1) for k, v in arrays.items()})
    back = ParameterDict("a_")
    back.get("weight", shape=(3, 0))
    back.get("bias", shape=(0,))
    back.load(str(tmp_path / "jax.params"), ctx=cpu())
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].data().torch().detach().numpy(), v + 1)

def test_parameter_dict_load_checks_missing_and_extra(tmp_path):
    arrays = _arrays(2)
    nd.save(str(tmp_path / "f.params"),
            {k: nd.array(v) for k, v in arrays.items()})
    pd = ParameterDict("a_")
    pd.get("weight", shape=(3, 4))
    with pytest.raises(KeyError, match="extra"):
        pd.load(str(tmp_path / "f.params"))
    pd.load(str(tmp_path / "f.params"), ignore_extra=True)
    pd.get("other", shape=(2,))
    with pytest.raises(KeyError, match="missing"):
        pd.load(str(tmp_path / "f.params"), ignore_extra=True)
    pd.load(str(tmp_path / "f.params"), ignore_extra=True,
            allow_missing=True)


def test_constant_holds_its_value_and_takes_no_gradient():
    c = gluon.Constant("c", [[1.0, 2.0]])
    c.initialize(ctx=cpu())
    assert c.grad_req == "null" and not c.data().torch().requires_grad
    assert torch.equal(c.data().torch(), torch.tensor([[1.0, 2.0]]))
    assert mx.gluon.Constant("c", nd.array([[1.0, 2.0]])).shape == c.shape
