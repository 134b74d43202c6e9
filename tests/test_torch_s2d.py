"""The port's ``SpaceToDepthStem`` (``models/resnet.py``, ``stem_s2d=True``)
against the JAX package's and against the standard 7x7, stride-2 stem.

The stem is the standard stem's function in another form, from the same
(7, 7, C, O) HWIO parameter: the same numpy weights go to every side. f32
throughout; the tolerances cover sums taken in other orders (the JAX test
of the stem, ``tests/test_model_zoo.py``, holds the forward at 1e-5 and the
weight gradient at 1e-4).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models import resnet as jresnet
from incubator_mxnet_tpu_torch import cpu, gluon
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import resnet

STEMS = [(3, 16, 32, 32), (3, 8, 18, 22), (4, 12, 16, 16)]


def stem_inputs(c, o, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, c).astype(np.float32)
    wt = (rng.randn(7, 7, c, o) * 0.1).astype(np.float32)
    cot = rng.randn(2, h // 2, w // 2, o).astype(np.float32)
    return x, wt, cot


def port_stem(wt):
    stem = resnet.SpaceToDepthStem(wt.shape[3], in_channels=wt.shape[2])
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(wt))
    return stem


def forward_and_grad(block, x, cot):
    """The block's output on `x` and the gradient of sum(y * cot) with
    respect to its weight."""
    block.weight.grad = None
    y = block(torch.from_numpy(x))
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), block.weight.grad.numpy()


@pytest.mark.parametrize("c, o, h, w", STEMS)
def test_stem_matches_the_jax_stem(c, o, h, w):
    x, wt, cot = stem_inputs(c, o, h, w)
    jstem = jresnet.SpaceToDepthStem(o, in_channels=c)
    jstem.initialize()
    jstem(nd.array(x))
    jstem.weight.set_data(nd.array(wt))
    with jautograd.record():
        loss = (jstem(nd.array(x)) * nd.array(cot)).sum()
    loss.backward()
    want_y = jstem(nd.array(x)).asnumpy()
    want_g = jstem.weight.grad().asnumpy()
    got_y, got_g = forward_and_grad(port_stem(wt), x, cot)
    assert got_y.shape == (2, h // 2, w // 2, o)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c, o, h, w", STEMS)
def test_stem_is_the_standard_stem(c, o, h, w):
    """The same function as the 7x7, stride-2, pad-3 conv from the same
    parameter: forward, and the weight gradient at 1e-4."""
    x, wt, cot = stem_inputs(c, o, h, w, seed=1)
    conv = gluon.nn.Conv2D(o, 7, strides=2, padding=3, use_bias=False,
                           layout="NHWC", in_channels=c)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wt))
    want_y, want_g = forward_and_grad(conv, x, cot)
    got_y, got_g = forward_and_grad(port_stem(wt), x, cot)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-4)


def test_stem_in_bfloat16_rounds_the_rearranged_weight_once():
    """A bf16 module: the weight is padded and rearranged in f32 and cast
    once to x's dtype, so the stem's weight is the standard stem's bf16
    weight, value for value."""
    x, wt, _ = stem_inputs(3, 16, 32, 32, seed=2)
    stem = port_stem(wt).to(torch.bfloat16)
    conv = gluon.nn.Conv2D(16, 7, strides=2, padding=3, use_bias=False,
                           layout="NHWC", in_channels=3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wt))
    conv = conv.to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got, want = stem(xb).float(), conv(xb).float()
    assert stem(xb).dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


def jax_resnet18_s2d():
    """The JAX zoo's resnet18_v1(stem_s2d=True, classes=10), shaped at 32 x
    32, with random He-scaled weights and moving statistics; returns the
    net and its arrays by name."""
    jnet = jresnet.resnet18_v1(classes=10, stem_s2d=True)
    jnet.initialize(init=mx.init.Normal(0.02))
    jnet(nd.array(np.zeros((1, 32, 32, 3), np.float32)))
    rng = np.random.RandomState(4)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = p.shape
        if leaf == "gamma":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf in ("beta", "bias", "running_mean"):
            a = 0.1 * rng.randn(*shape)
        elif leaf == "running_var":
            a = 0.5 + rng.rand(*shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[1]
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        a = a.astype(np.float32)
        p.set_data(nd.array(a))
        arrays[name] = a
    return jnet, arrays


def test_resnet18_with_the_s2d_stem_matches_jax():
    jnet, arrays = jax_resnet18_s2d()
    tnet = load_jax_params(
        resnet.resnet18_v1(classes=10, stem_s2d=True, ctx=cpu()), arrays)
    assert isinstance(tnet.features[0], resnet.SpaceToDepthStem)
    x = np.random.RandomState(5).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jnet(nd.array(x)).asnumpy(), rtol=1e-4,
                               atol=1e-4)


def test_a_standard_stem_state_dict_loads_into_the_s2d_model():
    """The same names and shapes: a standard-stem ResNet's state dict loads
    into the s2d ResNet as it is, and both predict the same."""
    std = resnet.resnet18_v1(classes=10, ctx=cpu(), seed=3, sigma=0.1)
    s2d = resnet.resnet18_v1(classes=10, stem_s2d=True, ctx=cpu(), seed=9)
    assert ({k: v.shape for k, v in std.state_dict().items()}
            == {k: v.shape for k, v in s2d.state_dict().items()})
    s2d.load_state_dict(std.state_dict())
    x = torch.from_numpy(
        np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        got, want = s2d(x).numpy(), std(x).numpy()
    # weights of 0.1 grow the logits to about 1e5: within 2e-5 of the
    # largest, as the JAX package's checkpoint test holds its own
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_the_s2d_stem_refuses_nchw_odd_sizes_and_other_channels():
    with pytest.raises(ValueError, match="stem_s2d requires layout='NHWC'"):
        resnet.resnet18_v1(classes=10, layout="NCHW", stem_s2d=True,
                           ctx=cpu())
    with pytest.raises(ValueError, match="stem_s2d requires layout='NHWC'"):
        jresnet.resnet18_v1(classes=10, layout="NCHW", stem_s2d=True)
    stem = resnet.SpaceToDepthStem(8)
    with pytest.raises(ValueError, match="needs even H/W"):
        stem(torch.zeros(1, 31, 32, 3))
    with pytest.raises(ValueError, match="built for 3 input channels, got 4"):
        stem(torch.zeros(1, 32, 32, 4))


def test_the_s2d_resnet_trains_like_the_standard_one():
    """One SGD step through the s2d ResNet and the standard one from the
    same weights: the same loss, and the stem's weight gradient within
    1e-4 of its largest."""
    from incubator_mxnet_tpu_torch import autograd
    std = resnet.resnet18_v1(classes=10, ctx=cpu(), seed=2)
    s2d = resnet.resnet18_v1(classes=10, stem_s2d=True, ctx=cpu(), seed=2)
    x = torch.from_numpy(
        np.random.RandomState(7).randn(4, 32, 32, 3).astype(np.float32))
    y = torch.tensor([1, 3, 5, 7])
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for net in (std, s2d):
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        autograd.backward(loss)
        out.append((float(loss.detach()), net.features[0].weight.grad))
    (l_std, g_std), (l_s2d, g_s2d) = out
    assert abs(l_std - l_s2d) <= 1e-5 * abs(l_std)
    scale = float(g_std.abs().max())
    assert float((g_s2d - g_std).abs().max()) <= 1e-4 * scale

