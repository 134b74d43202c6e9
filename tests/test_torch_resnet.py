"""ResNet through the port against the JAX package, on small widths and
32 x 32 NHWC images.

* The port's zoo (``models/resnet.py``) against the JAX zoo: v1 and v2,
  bottleneck and basic blocks, in predict mode and in training mode (the
  batch statistics and the moving statistics they update).
* The user network ``chip_smoke.resnet50_v1_bnrelu`` (BatchNormReLU in
  training, ``ops.ConvBNReLU`` in predict mode) against the same network
  written with the JAX package's public layers, its Pallas kernels selected
  (``MXTPU_PALLAS=force``, interpret mode): the predict forward, and one
  training forward, backward and ``Trainer("sgd", momentum=0.9, wd=1e-4)``
  step.
* ``load_jax_params`` with BatchNorm's buffers, and ``FrozenModel`` on
  float images.

The same numpy weights go to both sides. f32 throughout; the tolerances
cover sums taken in other orders.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import ops as jops
from incubator_mxnet_tpu import profiler as jax_prof
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.block import HybridBlock
from incubator_mxnet_tpu.models import resnet as jresnet
from incubator_mxnet_tpu.ops import _raw as jraw
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, ops
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import resnet
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
from incubator_mxnet_tpu_torch.serving import FrozenModel

LAYERS = (1, 1, 1, 1)
CHANNELS = (8, 16, 32, 64, 128)
CLASSES = 10
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_arrays(net, seed):
    """Random values for every parameter and moving statistic of a JAX
    net (already initialized and shaped): He-scaled conv weights so that
    predict mode keeps its scale, gamma near one, a positive variance.
    Sets them on the net and returns them as numpy arrays by name."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
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
    return arrays


def images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def jax_moving_stats(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if k.endswith(("running_mean", "running_var"))}


def port_moving_stats(net):
    return {k: b.numpy() for k, b in net.named_buffers()}


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

ZOO = [("v1_bottleneck", 1, "BottleneckV1"), ("v2_bottleneck", 2,
                                              "BottleneckV2"),
       ("v1_basic", 1, "BasicBlockV1"), ("v2_basic", 2, "BasicBlockV2")]


@pytest.mark.parametrize("case", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_resnet_matches_jax_in_predict_and_training_mode(case):
    _, version, block = case
    jcls = jresnet.ResNetV1 if version == 1 else jresnet.ResNetV2
    tcls = resnet.ResNetV1 if version == 1 else resnet.ResNetV2
    jnet = jcls(getattr(jresnet, block), list(LAYERS), list(CHANNELS),
                classes=CLASSES)
    jnet.initialize(init=mx.init.Normal(0.02))
    jnet(nd.array(images(1, 0)))               # shapes are deferred there
    arrays = jax_arrays(jnet, seed=version)
    tnet = load_jax_params(tcls(getattr(resnet, block), list(LAYERS),
                                list(CHANNELS), classes=CLASSES), arrays)
    x = images(4, 1)
    with torch.no_grad():
        np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(),
                                   jnet(nd.array(x)).asnumpy(), **TOL)
    # training mode: batch statistics, and the moving statistics update
    with jautograd.record():
        y_j = jnet(nd.array(x)).asnumpy()
    with autograd.record():
        y_t = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, **TOL)
    want = jax_moving_stats(jnet)
    got = port_moving_stats(tnet)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# the user network: BatchNormReLU in training, ConvBNReLU in predict mode
# ---------------------------------------------------------------------------

class JaxConvBN(HybridBlock):
    """The ConvBN block of chip_smoke.resnet50_v1_bnrelu with the JAX
    package's public layers."""

    def __init__(self, ch, kernel, stride, pad, in_ch, relu):
        super().__init__()
        self.conv = jnn.Conv2D(ch, kernel, strides=stride, padding=pad,
                               use_bias=False, layout="NHWC",
                               in_channels=in_ch)
        self.bn = (jnn.BatchNormReLU if relu else jnn.BatchNorm)(
            axis=-1, in_channels=ch)
        self._geometry = ((stride, stride), (pad, pad))
        self._act = "relu" if relu else None

    def forward(self, x):
        if jautograd.is_training():
            return self.bn(self.conv(x))
        stride, pad = self._geometry
        return jops.ConvBNReLU(
            x, self.conv.weight.data(), self.bn.gamma.data(),
            self.bn.beta.data(), self.bn.running_mean.data(),
            self.bn.running_var.data(), stride=stride, pad=pad,
            act_type=self._act)


class JaxBottleneck(HybridBlock):
    def __init__(self, ch, stride, downsample, in_ch):
        super().__init__()
        mid = ch // 4
        self.body = jnn.HybridSequential()
        self.body.add(JaxConvBN(mid, 1, stride, 0, in_ch, True),
                      JaxConvBN(mid, 3, 1, 1, mid, True),
                      JaxConvBN(ch, 1, 1, 0, mid, False))
        self.downsample = (JaxConvBN(ch, 1, stride, 0, in_ch, False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return (self.body(x) + residual).relu()


class JaxResNetBNReLU(HybridBlock):
    def __init__(self):
        super().__init__()
        self.features = jnn.HybridSequential()
        self.features.add(JaxConvBN(CHANNELS[0], 7, 2, 3, 3, True),
                          jnn.MaxPool2D(3, 2, 1, layout="NHWC"))
        in_ch = CHANNELS[0]
        for i, n in enumerate(LAYERS):
            stride = 1 if i == 0 else 2
            stage = jnn.HybridSequential()
            stage.add(JaxBottleneck(CHANNELS[i + 1], stride,
                                    CHANNELS[i + 1] != in_ch or stride != 1,
                                    in_ch))
            for _ in range(n - 1):
                stage.add(JaxBottleneck(CHANNELS[i + 1], 1, False,
                                        CHANNELS[i + 1]))
            in_ch = CHANNELS[i + 1]
            self.features.add(stage)
        self.features.add(jnn.GlobalAvgPool2D(layout="NHWC"), jnn.Flatten())
        self.output = jnn.Dense(CLASSES, in_units=in_ch)

    def forward(self, x):
        return self.output(self.features(x))


def bnrelu_pair(seed):
    jnet = JaxResNetBNReLU()
    jnet.initialize(init=mx.init.Normal(0.02))
    arrays = jax_arrays(jnet, seed)
    tnet = chip_smoke.resnet50_v1_bnrelu(classes=CLASSES, layers=LAYERS,
                                         channels=CHANNELS, ctx=cpu())
    return jnet, load_jax_params(tnet, arrays), arrays


def test_bnrelu_network_predict_matches_jax_through_the_kernels(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=3)
    x = images(3, 4)
    jax_prof.reset_counters()
    want = jnet(nd.array(x)).asnumpy()
    n_convs = 1 + 3 * sum(LAYERS) + len(LAYERS)
    assert (jax_prof.counters().get("ops/pallas.selected.conv_bn_relu")
            == n_convs)
    cbr.reset_counts()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    ssa, mm = chip_smoke.bnrelu_launches(LAYERS)["predict"]
    assert ssa + mm == n_convs
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == (ssa, mm)
    assert cbr.ssa_launches == cbr.mm_launches == cbr.nhwc_copies == 0
    np.testing.assert_allclose(got, want, **TOL)


def test_bnrelu_network_training_step_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=5)
    x = images(4, 6)
    y = np.random.RandomState(7).randint(0, CLASSES, 4).astype(np.int32)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}

    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    with jautograd.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(nd.array(x)),
                                                   nd.array(y, dtype="int32"))
    jl.backward()
    jtr.step(4)

    ttr = gluon.Trainer(tnet, "sgd", dict(opt))
    cbr.reset_counts()
    with autograd.record():
        tl = gluon.loss.SoftmaxCrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                                  torch.from_numpy(y))
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == \
        chip_smoke.bnrelu_launches(LAYERS)["train"]
    autograd.backward(tl)
    ttr.step(4)

    np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), **TOL)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), err_msg=name,
                                   **TOL)
    want = jax_moving_stats(jnet)
    for name, b in port_moving_stats(tnet).items():
        np.testing.assert_allclose(b, want[name], err_msg=name, **TOL)


def test_bnrelu_names_map_onto_the_zoo():
    """Every parameter and buffer of the user network has a zoo
    ``resnet50_v1`` counterpart of its shape, and the two predict alike
    from the same weights (the zoo through BatchNorm + relu)."""
    _, tnet, arrays = bnrelu_pair(seed=8)
    zoo = resnet.ResNetV1(resnet.BottleneckV1, list(LAYERS), list(CHANNELS),
                          classes=CLASSES)
    load_jax_params(zoo, {chip_smoke.zoo_name(k): v
                          for k, v in arrays.items()})
    x = torch.from_numpy(images(2, 9))
    with torch.inference_mode():
        np.testing.assert_allclose(zoo(x).numpy(), tnet(x).numpy(), **TOL)


def test_bnrelu_launch_counts_of_resnet50():
    assert chip_smoke.bnrelu_launches() == {"train": (33, 0),
                                            "predict": (23, 30)}


# ---------------------------------------------------------------------------
# layers, conversion and serving
# ---------------------------------------------------------------------------

CONVS = [  # (kernel, stride, pad, dilate, groups)
    (3, 1, 1, 1, 1), (1, 2, 0, 1, 1), (7, 2, 3, 1, 1), (3, 1, 2, 2, 1),
    (3, 2, 1, 1, 4),
]


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("conv", CONVS, ids=lambda c: "k{}s{}p{}d{}g{}".format(
    *c))
def test_conv_matches_jax(conv, layout):
    k, s, p, d, g = conv
    rng = np.random.RandomState(k * 10 + s)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    w = (0.2 * rng.randn(k, k, 8 // g, 12)).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    if layout == "NCHW":
        x, w = x.transpose(0, 3, 1, 2).copy(), w.transpose(3, 2, 0, 1).copy()
    kw = dict(stride=(s, s), pad=(p, p), dilate=(d, d), num_group=g,
              layout=layout)
    want = jraw.conv(*(nd.array(a)._data for a in (x, w, b)), **kw)
    got = ops.conv(*(torch.from_numpy(a) for a in (x, w, b)), **kw)
    if layout == "NHWC":
        assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


POOLS = [  # (kernel, stride, pad, ceil_mode)
    (3, 2, 1, False), (2, 2, 0, False), (3, 2, 0, True), (3, 1, 2, False),
]


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("pool", POOLS, ids=lambda c: "k{}s{}p{}c{}".format(
    *c))
def test_max_pooling_matches_jax(pool, layout):
    k, s, p, ceil = pool
    x = np.random.RandomState(k + p).randn(2, 9, 10, 5).astype(np.float32)
    if layout == "NCHW":
        x = x.transpose(0, 3, 1, 2).copy()
    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), layout=layout,
              ceil_mode=ceil)
    want = jraw.pooling(nd.array(x)._data, "max", **kw)
    got = ops.pooling(torch.from_numpy(x), "max", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool_type", ["avg", "max"])
def test_global_pooling_matches_jax(pool_type):
    x = np.random.RandomState(1).randn(2, 7, 7, 6).astype(np.float32)
    want = jraw.pooling(nd.array(x)._data, pool_type, global_pool=True,
                        layout="NHWC")
    got = ops.pooling(torch.from_numpy(x), pool_type, global_pool=True,
                      layout="NHWC")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_load_jax_params_fills_and_checks_buffers():
    _, tnet, arrays = bnrelu_pair(seed=10)
    name = "features.0.bn.running_var"
    np.testing.assert_array_equal(dict(tnet.named_buffers())[name].numpy(),
                                  arrays[name])
    fresh = chip_smoke.resnet50_v1_bnrelu(classes=CLASSES, layers=LAYERS,
                                          channels=CHANNELS, ctx=cpu())
    before = fresh.features[0].bn.running_mean.clone()
    missing = {k: v for k, v in arrays.items() if k != name}
    with pytest.raises(ValueError, match="missing.*running_var"):
        load_jax_params(fresh, missing)
    misshaped = dict(arrays, **{name: np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(fresh, misshaped)
    # nothing is copied when the check fails
    torch.testing.assert_close(fresh.features[0].bn.running_mean, before)


def test_frozen_model_serves_float_images_like_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=11)
    fm = FrozenModel(tnet, input_shape=(32, 32, 3), dtype="float32",
                     batch_buckets=(1, 2, 4), ctx=cpu())
    x = images(3, 12)
    cbr.reset_counts()
    (got,) = fm.predict_batch(x)
    ssa, mm = chip_smoke.bnrelu_launches(LAYERS)["predict"]
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == (ssa, mm)
    assert got.dtype == np.float32 and got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, jnet(nd.array(x)).asnumpy(), **TOL)
    with torch.inference_mode():
        direct = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)
