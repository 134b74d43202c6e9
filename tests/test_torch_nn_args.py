"""Layer arguments the port takes as the JAX package's layers take them, on
the CPU: ``LayerNorm(center=, scale=)``, ``Conv2D(activation=)``,
``MaxPool2D(count_include_pad=, ceil_mode=)`` and ``Embedding(
sparse_grad=, oor_policy=)``. One parametrised test an argument; each
gives both layers the same numpy input and weights and holds the outputs
(and, for the norms, which parameters train and their gradients) within
1e-5 relative, 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import autograd, cpu, nd
from incubator_mxnet_tpu_torch.gluon import nn

TOL = dict(rtol=1e-5, atol=1e-6)


def _copy(jlayer, tlayer):
    """The JAX layer's parameter values into the port layer, by name."""
    for name, p in jlayer.collect_params().items():
        tlayer.collect_params()[name.replace(jlayer.prefix, tlayer.prefix)
                                ].set_data(p.data().asnumpy())


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _layer_norm_case(center, scale):
    """Outputs, grad_reqs and gradients of both LayerNorms."""
    kw = dict(center=center, scale=scale, in_channels=6)
    jl, tl = mx.gluon.nn.LayerNorm(**kw), nn.LayerNorm(**kw)
    jl.initialize(mx.init.Uniform(0.5), ctx=mx.cpu())
    _copy(jl, tl)
    x = _x((4, 6))
    with jautograd.record():
        jy = (jl(jnd.array(x)) * jnd.array(x)).sum()
    jy.backward()
    with cpu(), autograd.record():
        ty = (tl(nd.array(x)) * nd.array(x)).sum()
    ty.backward()
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), **TOL)
    for leaf in ("gamma", "beta"):
        jp = jl.collect_params()[jl.prefix + leaf]
        tp = tl.collect_params()[tl.prefix + leaf]
        assert tp.grad_req == jp.grad_req
        if jp.grad_req != "null":
            np.testing.assert_allclose(tp.grad().asnumpy(),
                                       jp.grad().asnumpy(), **TOL)
    return {n: p.grad_req for n, p in tl.collect_params().items()}


@pytest.mark.parametrize("center", [True, False])
def test_layer_norm_center(center):
    reqs = _layer_norm_case(center, True)
    assert sorted(reqs.values()) == sorted(
        ["write", "write" if center else "null"])


@pytest.mark.parametrize("scale", [True, False])
def test_layer_norm_scale(scale):
    reqs = _layer_norm_case(True, scale)
    assert sorted(reqs.values()) == sorted(
        ["write", "write" if scale else "null"])


@pytest.mark.parametrize("activation", [None, "relu", "tanh"])
def test_conv2d_activation(activation):
    kw = dict(channels=3, kernel_size=3, padding=1, in_channels=2,
              activation=activation)
    jc, tc = mx.gluon.nn.Conv2D(**kw), nn.Conv2D(**kw)
    jc.initialize(mx.init.Uniform(0.5), ctx=mx.cpu())
    _copy(jc, tc)
    x = _x((2, 2, 5, 5))
    want = jc(jnd.array(x)).asnumpy()
    got = tc(nd.array(x, ctx=cpu())).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    if activation == "relu":
        assert (got >= 0).all() and (want < 0).sum() == 0


POOLS = {"k2s2p0": (2, 2, 0), "k3s2p1": (3, 2, 1), "k2s1p1": (2, 1, 1)}


def _pool(size, kw):
    k, s, p = POOLS[size]
    x = _x((2, 3, 7, 7), seed=1)
    want = mx.gluon.nn.MaxPool2D(k, s, p, **kw)(jnd.array(x)).asnumpy()
    got = nn.MaxPool2D(k, s, p, **kw)(nd.array(x, ctx=cpu())).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got.shape


@pytest.mark.parametrize("size", sorted(POOLS))
@pytest.mark.parametrize("count_include_pad", [True, False])
def test_max_pool_count_include_pad(size, count_include_pad):
    _pool(size, dict(count_include_pad=count_include_pad))


@pytest.mark.parametrize("size", sorted(POOLS))
@pytest.mark.parametrize("ceil_mode", [True, False])
def test_max_pool_ceil_mode(size, ceil_mode):
    shape = _pool(size, dict(ceil_mode=ceil_mode))
    if size == "k2s2p0":
        assert shape[-1] == (4 if ceil_mode else 3)


IDS = np.array([[0, 3, 9], [2, 11, -1]], np.int32)     # two out of range


def _embeddings(**kw):
    je = mx.gluon.nn.Embedding(10, 4, **kw)
    je.initialize(mx.init.Uniform(0.5), ctx=mx.cpu())
    te = nn.Embedding(10, 4, **kw)
    _copy(je, te)
    return je, te


@pytest.mark.parametrize("oor_policy", ["clip", "error"])
def test_embedding_oor_policy(oor_policy):
    je, te = _embeddings(oor_policy=oor_policy)
    inside = IDS.clip(0, 9)
    np.testing.assert_array_equal(te(nd.array(inside, ctx=cpu())).asnumpy(),
                                  je(jnd.array(inside)).asnumpy())
    if oor_policy == "clip":
        np.testing.assert_array_equal(
            te(nd.array(IDS, ctx=cpu())).asnumpy(),
            je(jnd.array(IDS)).asnumpy())
        return
    with pytest.raises(ValueError, match="2 id"):
        je(jnd.array(IDS))
    with pytest.raises(ValueError, match="2 id"):
        te(nd.array(IDS, ctx=cpu()))
    with pytest.raises(ValueError, match="oor_policy"):
        nn.Embedding(10, 4, oor_policy="wrap")


@pytest.mark.parametrize("sparse_grad", [False, True])
def test_embedding_sparse_grad(sparse_grad):
    if sparse_grad:
        je = mx.gluon.nn.Embedding(10, 4, sparse_grad=True)
        je.initialize(ctx=mx.cpu())
        assert je(jnd.array(IDS.clip(0, 9))).shape == (2, 3, 4)
        with pytest.raises(NotImplementedError, match=r"A\.5c"):
            nn.Embedding(10, 4, sparse_grad=True)
        return
    je, te = _embeddings(sparse_grad=False)
    x = IDS.clip(0, 9)
    with jautograd.record():
        jy = je(jnd.array(x)).sum()
    jy.backward()
    with autograd.record():
        ty = te(torch.from_numpy(x)).sum()
    autograd.backward(ty)
    grads = [p.grad() for p in te.collect_params().values()]
    np.testing.assert_allclose(grads[0].asnumpy(),
                               je.weight.grad().asnumpy(), **TOL)
