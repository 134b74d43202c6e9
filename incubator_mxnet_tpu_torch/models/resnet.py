"""ResNet v1/v2 (counterpart of ``incubator_mxnet_tpu/models/resnet.py``;
parity: python/mxnet/gluon/model_zoo/vision/resnet.py).

The same blocks, each a ``HybridBlock``, with the same child names
(``features.0.weight``, ``features.4.0.body.1.running_mean``,
``output.weight``, ...), so weights carry across by name
(``convert.load_jax_params``, ``load_parameters``). The default layout is
NHWC with HWIO conv weights, as in the JAX package. Shapes are deferred
where the JAX package defers them (the stem conv, every BatchNorm, the
inner convs of each block): the first call, ``load_parameters`` or
``load_jax_params`` completes them. BatchNorm follows
``autograd.is_training()``.

Every BatchNorm here is ``BatchNorm`` followed by a ReLU, as in the JAX
zoo, so this module runs none of the hand-written kernels; a network built
from ``BatchNormReLU`` and ``ops.ConvBNReLU`` does. ``stem_s2d=True`` (NHWC
only) puts :class:`SpaceToDepthStem` in the standard stem's place, with
the standard stem's parameter, so either network loads the other's
weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import initializer, ops
from ..context import as_context, cpu
from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "SpaceToDepthStem",
           "BasicBlockV1", "BottleneckV1",
           "BasicBlockV2", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv(channels, kernel, stride, pad, layout, in_channels=0):
    return nn.Conv2D(channels, kernel, strides=stride, padding=pad,
                     use_bias=False, layout=layout, in_channels=in_channels)


class SpaceToDepthStem(HybridBlock):
    """The 7x7, stride-2, pad-3 stem conv of an NHWC image, computed as the
    same function in another form (counterpart of the JAX
    ``SpaceToDepthStem``, MLPerf ResNet's space-to-depth stem).

    Its one parameter is the standard stem's: ``weight`` (7, 7, C, O),
    HWIO, so a state dict (or ``convert.load_jax_params``) carries between
    the two stems by name. The forward reshapes the image to (N, H/2, W/2,
    4C), pads the weight with one leading zero row and column (in f32) and
    rearranges it to (4, 4, 4C, O) in x's dtype, pads the image by 2
    before and 1 after on both spatial axes, and runs a stride-1 NHWC conv
    (``ops.conv``).

    Why it is the same function: y[p, q] = sum_{i, j} w[i, j] x[2p + i -
    3, 2q + j - 3]; with i = 2 ai + di - 1 (di in {0, 1}) the sum becomes a
    4-tap conv over the space-to-depth image, whose channel is (di, dj,
    c)."""

    def __init__(self, channels, in_channels=3, prefix=None, params=None):
        super().__init__(prefix, params)
        self.weight = self.params.get(
            "weight", shape=(7, 7, in_channels, channels))

    def forward(self, x):
        w = self.weight
        n, h, wd, c = x.shape
        if c != w.shape[2]:
            raise ValueError(
                f"SpaceToDepthStem was built for {w.shape[2]} input "
                f"channels, got {c}; pass in_channels= to match")
        if h % 2 or wd % 2:
            raise ValueError(
                f"SpaceToDepthStem needs even H/W, got {(h, wd)}")
        xs = (x.reshape(n, h // 2, 2, wd // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5)
              .reshape(n, h // 2, wd // 2, 4 * c))
        # kernel index i = 2 ai + di - 1: one zero row and column in front
        # make wp[2 ai + di] == w[i] (wp[0] is the zero of i = -1)
        wf = w.float()
        wp = F.pad(wf, (0, 0, 0, 0, 1, 0, 1, 0))
        o = wf.shape[-1]
        w2 = (wp.reshape(4, 2, 4, 2, c, o)
              .permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, o)).to(xs.dtype)
        xs = F.pad(xs, (0, 0, 2, 1, 2, 1))
        return ops.conv(xs, w2, layout="NHWC")


def _bn(layout, **kw):
    return nn.BatchNorm(axis=-1 if layout == "NHWC" else 1, **kw)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NHWC", **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(_conv(channels, 3, stride, 1, layout, in_channels))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv(channels, 3, 1, 1, layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(_conv(channels, 1, stride, 0, layout,
                                      in_channels))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return (self.body(x) + residual).relu()


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NHWC", **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(_conv(mid, 1, stride, 0, layout, in_channels))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv(mid, 3, 1, 1, layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv(channels, 1, 1, 0, layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(_conv(channels, 1, stride, 0, layout,
                                      in_channels))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return (self.body(x) + residual).relu()


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NHWC", **kwargs):
        super().__init__(**kwargs)
        self.bn1 = _bn(layout)
        self.conv1 = _conv(channels, 3, stride, 1, layout, in_channels)
        self.bn2 = _bn(layout)
        self.conv2 = _conv(channels, 3, 1, 1, layout)
        self.downsample = (_conv(channels, 1, stride, 0, layout, in_channels)
                           if downsample else None)

    def forward(self, x):
        bn1 = self.bn1(x).relu()
        residual = x if self.downsample is None else self.downsample(bn1)
        out = self.conv1(bn1)
        out = self.conv2(self.bn2(out).relu())
        return out + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NHWC", **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = _bn(layout)
        self.conv1 = _conv(mid, 1, 1, 0, layout, in_channels)
        self.bn2 = _bn(layout)
        self.conv2 = _conv(mid, 3, stride, 1, layout)
        self.bn3 = _bn(layout)
        self.conv3 = _conv(channels, 1, 1, 0, layout)
        self.downsample = (_conv(channels, 1, stride, 0, layout, in_channels)
                           if downsample else None)

    def forward(self, x):
        bn1 = self.bn1(x).relu()
        residual = x if self.downsample is None else self.downsample(bn1)
        out = self.conv1(bn1)
        out = self.conv2(self.bn2(out).relu())
        out = self.conv3(self.bn3(out).relu())
        return out + residual


class _ResNetBase(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, layout="NHWC",
                 thumbnail=False, version=1, stem_s2d=False, in_channels=3,
                 **kwargs):
        super().__init__(**kwargs)
        self._layout = layout
        self._in_channels = in_channels
        self.features = nn.HybridSequential()
        if version == 2:
            self.features.add(_bn(layout, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv(channels[0], 3, 1, 1, layout))
        else:
            if stem_s2d:
                if layout != "NHWC":
                    raise ValueError("stem_s2d requires layout='NHWC'")
                self.features.add(SpaceToDepthStem(channels[0], in_channels))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, strides=2,
                                            padding=3, use_bias=False,
                                            layout=layout))
            if version == 1:
                self.features.add(_bn(layout))
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_ch = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            stage = nn.HybridSequential()
            stage.add(block(channels[i + 1], stride,
                            downsample=(channels[i + 1] != in_ch
                                        or stride != 1),
                            in_channels=in_ch, layout=layout))
            for _ in range(num_layer - 1):
                stage.add(block(channels[i + 1], 1,
                                in_channels=channels[i + 1], layout=layout))
            in_ch = channels[i + 1]
            self.features.add(stage)
        if version == 2:
            self.features.add(_bn(layout))
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_ch)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV1(_ResNetBase):
    def __init__(self, block, layers, channels, **kwargs):
        super().__init__(block, layers, channels, version=1, **kwargs)


class ResNetV2(_ResNetBase):
    def __init__(self, block, layers, channels, **kwargs):
        super().__init__(block, layers, channels, version=2, **kwargs)


_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {1: {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
           2: {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}}


def _infer_channels(block, c, layout):
    """Complete `block`'s deferred shapes for an input of `c` channels
    from the channel counts alone, and return its output's: a layer's
    ``infer_shape`` reads an empty meta tensor of `c` channels (nothing is
    computed); a block's children take the data in the order they were
    added, its ``downsample`` branch the block's own input."""
    if block._pending:
        block._deferred_infer(torch.empty(
            (1, 1, 1, c) if layout == "NHWC" else (1, c, 1, 1),
            device="meta"))
    if isinstance(block, nn.Conv2D):
        return block._channels
    if isinstance(block, SpaceToDepthStem):
        return block.weight.shape[-1]
    out = c
    for name, child in block._modules.items():
        if name == "downsample":
            _infer_channels(child, c, layout)
        elif isinstance(child, HybridBlock):
            out = _infer_channels(child, out, layout)
    return out


def get_resnet(version, num_layers, classes=1000, layout="NHWC", ctx=None,
               seed=None, sigma=0.02, **kwargs):
    """ResNet `version` of `num_layers`, built as the JAX package builds
    it. `ctx` defaults to ``gpu(0)`` and raises without a card unless
    ``ctx=cpu()``.

    Without a `seed` the shapes stay deferred (on `ctx`) and nothing is
    drawn: the MXNet flow follows (``net.initialize(init, ctx)`` and a
    first batch, or ``load_parameters``, ``load_jax_params``). With a
    `seed`, the shapes are completed from the channel counts
    (:func:`_infer_channels`), the weights drawn by
    :func:`gluon.nn.init_params` from `seed` and `sigma`, and the network
    put on `ctx`."""
    device = as_context(ctx).device        # raises without a card
    btype, layers, channels = _SPEC[num_layers]
    cls = ResNetV1 if version == 1 else ResNetV2
    net = cls(_BLOCKS[version][btype], layers, channels, classes=classes,
              layout=layout, **kwargs)
    if seed is None:
        return net.to(device)
    net.initialize(initializer.Zero(), ctx=cpu())
    _infer_channels(net, net._in_channels, layout)
    nn.init_params(net, sigma=sigma, seed=seed)
    return net.to(device)


def _make(version, n):
    def f(classes=1000, layout="NHWC", ctx=None, **kwargs):
        return get_resnet(version, n, classes=classes, layout=layout,
                          ctx=ctx, **kwargs)
    f.__name__ = f.__qualname__ = f"resnet{n}_v{version}"
    f.__doc__ = f"ResNet-{n} v{version}, as :func:`get_resnet`."
    return f


resnet18_v1 = _make(1, 18)
resnet34_v1 = _make(1, 34)
resnet50_v1 = _make(1, 50)
resnet101_v1 = _make(1, 101)
resnet152_v1 = _make(1, 152)
resnet18_v2 = _make(2, 18)
resnet34_v2 = _make(2, 34)
resnet50_v2 = _make(2, 50)
resnet101_v2 = _make(2, 101)
resnet152_v2 = _make(2, 152)
