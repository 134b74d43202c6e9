"""The port's Block and HybridBlock against the JAX package's: the zoo
ResNets' parameter names and shapes before and after the first call, the
``save_parameters`` file read by the JAX package and three SGD steps on
both sides from it, ``hybridize`` on the CPU, the CUDA-graph path's
bookkeeping with the graph faked, and what is not ported yet."""
import contextlib

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.base import NameManager as JNameManager
from incubator_mxnet_tpu.models import resnet as jresnet
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, init
from incubator_mxnet_tpu_torch.gluon import block as tblock
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.block import NameManager
from incubator_mxnet_tpu_torch.models import resnet
from incubator_mxnet_tpu_torch.ops import cuda as tcuda


def _fresh_names():
    JNameManager._tls.nm = JNameManager()
    NameManager.reset()


def _shapes(params):
    return {k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("build", [
    lambda m, **kw: m.get_resnet(1, 50, classes=10, **kw),
    lambda m, **kw: m.resnet18_v1(classes=10, **kw)],
    ids=["resnet50_v1", "resnet18_v1"])
def test_collect_params_has_the_jax_names_and_shapes(build):
    _fresh_names()
    jnet = build(jresnet)
    tnet = build(resnet, ctx=cpu())
    assert _shapes(tnet.collect_params()) == _shapes(jnet.collect_params())
    assert any(0 in s for s in _shapes(tnet.collect_params()).values())
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(x))
    tnet.initialize(init.Xavier(), ctx=cpu())
    tnet(torch.from_numpy(x))
    got = _shapes(tnet.collect_params())
    assert got == _shapes(jnet.collect_params())
    assert not any(0 in s for s in got.values())
    assert (set(tnet._collect_params_with_prefix())
            == set(jnet._collect_params_with_prefix())
            == set(tnet.state_dict()))


def _sgd_steps(net, loss_fn, trainer, x, y, record, backward, steps=3):
    losses = []
    for _ in range(steps):
        with record():
            loss = loss_fn(net(x), y)
        backward(loss)
        trainer.step(x.shape[0])
        losses.append(float(np.asarray(
            loss.mean().asnumpy() if hasattr(loss, "asnumpy")
            else loss.detach().mean().numpy())))
    return losses


def test_the_port_file_trains_the_same_in_both_packages(tmp_path):
    """The port's resnet18_v1, Xavier-initialized and saved; the JAX zoo's
    loads the file; three SGD steps through Trainer(collect_params()) on
    each side from the same batch: the losses and every weight within
    1e-4."""
    _fresh_names()
    rng = np.random.RandomState(3)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)
    tnet = resnet.resnet18_v1(classes=10, ctx=cpu())
    tnet.initialize(init.Xavier(rnd_type="gaussian", factor_type="in",
                                magnitude=2), ctx=cpu())
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    fname = str(tmp_path / "resnet18.params")
    tnet.save_parameters(fname)
    jnet = jresnet.resnet18_v1(classes=10)
    jnet.load_parameters(fname)
    sgd = {"learning_rate": 0.001, "momentum": 0.9, "wd": 1e-4}
    tl = _sgd_steps(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                    gluon.Trainer(tnet.collect_params(), "sgd", dict(sgd)),
                    torch.from_numpy(x), torch.from_numpy(y),
                    autograd.record, lambda l: autograd.backward(l))
    jl = _sgd_steps(jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(sgd)),
                    nd.array(x), nd.array(y.astype(np.float32)),
                    jautograd.record, lambda l: l.backward())
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().torch().detach().numpy(),
                                   jp[name].data().asnumpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_either_package_loads_the_others_resnet_file(tmp_path, name,
                                                     writer):
    """A zoo ResNet initialized and shaped by one package, saved with
    save_parameters; the other package's fresh (deferred) net loads the
    file and predicts the same."""
    _fresh_names()
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    fname = str(tmp_path / "net.params")
    jnet = getattr(jresnet, name)(classes=10)
    tnet = getattr(resnet, name)(classes=10, ctx=cpu())
    if writer == "jax":
        jnet.initialize(mx.init.Xavier())
        jnet(nd.array(x))
        jnet.save_parameters(fname)
        tnet.load_parameters(fname, ctx=cpu())
    else:
        tnet.initialize(init.Xavier(), ctx=cpu())
        tnet(torch.from_numpy(x))
        tnet.save_parameters(fname)
        jnet.load_parameters(fname)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jnet(nd.array(x)).asnumpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(KeyError, match="missing"):
        nn.Dense(3).load_parameters(fname)


def test_hybridize_changes_no_cpu_answer():
    _fresh_names()
    net = resnet.resnet18_v1(classes=10, ctx=cpu(), seed=1)
    x = torch.from_numpy(
        np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        before = net(x)
        net.hybridize()
        assert net._active and net.features[4]._active
        after = net(x)
    assert torch.equal(before, after)
    assert net.captures == 0


def test_symbol_block_export_and_shard_raise_naming_their_items():
    net = nn.Dense(2, in_units=3)
    with pytest.raises(NotImplementedError, match="A.9"):
        gluon.SymbolBlock([], [])
    with pytest.raises(NotImplementedError, match="A.9"):
        gluon.SymbolBlock.imports("x-symbol.json", ["data"])
    with pytest.raises(NotImplementedError, match="A.9"):
        net.export("x")
    with pytest.raises(NotImplementedError, match="A.10"):
        net.shard()


class _FakeGraph:
    """A CUDA graph stand-in: its replay runs the captured block again on
    the static inputs and copies into the static outputs. Like the real
    one, it can be neither copied nor pickled."""
    replays = 0

    def register_generator_state(self, gen):
        pass

    def __reduce_ex__(self, protocol):
        raise TypeError("cannot pickle a CUDA graph")


@pytest.fixture
def fake_card(monkeypatch):
    """The hybridized path's CUDA calls faked on the CPU."""
    stream = type("S", (), {"wait_stream": lambda self, other: None})()
    monkeypatch.setattr(tblock, "_on_card", lambda args: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(tcuda, "register_generator", lambda g, gen: None)
    real = tblock.HybridBlock._capture

    def capture(self, args):
        g = real(self, args)

        def replay():
            # Python runs no forward in a real replay: the children take
            # no graph path of their own here either
            _FakeGraph.replays += 1
            tblock._CAPTURING.on = True
            try:
                with torch.no_grad():
                    outs, _ = tcuda.flatten(tblock.Block.__call__(
                        self, *g.inputs))
            finally:
                tblock._CAPTURING.on = False
            for o, n in zip(g.outputs, outs):
                o.copy_(n)
        g.graph.replay = replay
        return g
    monkeypatch.setattr(tblock.HybridBlock, "_capture", capture)
    _FakeGraph.replays = 0


def test_hybridized_calls_capture_once_a_signature(fake_card):
    """One capture per input signature, none on a repeat, answers equal to
    the eager forward, a replay per call; set_data reaches the next
    answer; a storage change (cast) drops the graphs; calls under record()
    run op by op."""
    _fresh_names()
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize(init.Xavier(), ctx=cpu())
    x8, x4 = torch.randn(8, 5), torch.randn(4, 5)
    net(x8)                         # completes the shapes, eagerly
    with torch.no_grad():
        eager8, eager4 = net(x8), net(x4)
    net.hybridize()
    for x, want in ((x8, eager8), (x4, eager4), (x8, eager8)):
        assert torch.equal(net(x), want)
    assert net.captures == 2 and _FakeGraph.replays == 3
    w = net.collect_params()[net[1].prefix + "weight"]
    w.set_data(torch.zeros(3, 8))
    assert float(net(x8).abs().sum()) == float(
        net[1].bias.detach().abs().sum() * 8)
    net.cast("float64")
    net(x8.double())
    assert net.captures == 3
    with autograd.record():
        out = net(x8.double())
    assert out.requires_grad and net.captures == 3


def test_a_hybridized_block_copies_pickles_and_freezes_without_its_graphs(
        fake_card):
    """After a replay, copy.deepcopy, pickle and freeze (a FrozenModel
    deep-copies its block) leave the graphs behind: the copy stays
    hybridized, answers as the original, and captures its own graph."""
    import copy
    import pickle
    _fresh_names()
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize(init.Xavier(), ctx=cpu())
    x = torch.randn(4, 5)
    net(x)                          # completes the shapes, eagerly
    net.hybridize()
    want = net(x)
    assert net.captures == 1 and len(net._graphs) == 1
    with pytest.raises(TypeError, match="CUDA graph"):
        pickle.dumps(net._graphs)
    for other in (copy.deepcopy(net), pickle.loads(pickle.dumps(net))):
        assert other._active and other._graphs == {}
        assert other.captures == 0 and other._pool is None
        assert torch.equal(other(x), want) and other.captures == 1
    frozen = net.freeze((5,), batch_buckets=(4,), ctx=cpu())
    assert torch.equal(frozen(x.numpy()), want)
    assert net.captures == 1 and len(net._graphs) == 1


def test_a_copied_or_pickled_block_keeps_its_parameters_bound():
    """FrozenModel deep-copies its block: the copy's Parameters name the
    copy's tensors (also buffers that Module.to() replaced while their
    shapes were deferred), and the copy frees without the collector."""
    import copy
    import gc
    import pickle
    import weakref
    _fresh_names()
    net = resnet.resnet18_v1(classes=10, ctx=cpu()).to(torch.float64)
    net.initialize(init.Xavier(), ctx=cpu())
    x = torch.rand(2, 32, 32, 3, dtype=torch.float64)
    with torch.no_grad():
        want = net(x)
    for other in (copy.deepcopy(net), pickle.loads(pickle.dumps(net))):
        bn = other.features[1]
        p = other.collect_params()[bn.prefix + "running_var"]
        assert p.data().torch() is bn.running_var and p._owner() is bn
        with torch.no_grad():
            assert torch.equal(other(x), want)
    copied = copy.deepcopy(net)
    gone = weakref.ref(copied)
    was = gc.isenabled()
    gc.disable()
    try:
        del copied
        assert gone() is None
    finally:
        if was:
            gc.enable()
