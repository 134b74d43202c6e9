"""NDArray as the user-facing array of the port's Gluon, autograd, metrics
and fused step, on the CPU, against the JAX package.

- A small Conv/Dense network given NDArrays answers with NDArrays equal to
  the same network given tensors (bit for bit) and to the JAX network
  (1e-5 relative, 1e-6 absolute), hybridized or not; three Trainer steps
  through ``record`` and ``loss.backward()`` on NDArrays leave the JAX
  network's weights (1e-5).
- ``Parameter.data()`` and ``grad()`` are NDArrays; a write to
  ``p.data()`` reaches the next forward in the parameter's own storage
  (the tensor and the storage epoch do not change), as ``set_data`` does,
  and ``set_data`` takes an NDArray.
- Every metric takes NDArrays and reads what the JAX package's reads from
  the same values (1e-6).
- ``FusedTrainStep`` and ``TrainLoop`` given NDArrays return NDArrays,
  equal to the tensor path's answers from the same weights (bit for
  bit); ``TrainLoop.fit`` takes batches of NDArrays.
- The minimal user flow of the JAX package (``nd.random.uniform``,
  ``attach_grad``, ``record``, ``nd.dot``, ``w[:] = w - lr * w.grad``).
"""
import copy

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import (TrainLoop, autograd, cpu, gluon,
                                       metric, nd, optimizer)
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon.parameter import storage_epoch
from incubator_mxnet_tpu_torch.parallel import FusedTrainStep

TOL = dict(rtol=1e-5, atol=1e-6)


def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=2, activation="relu"),
            nn.MaxPool2D(2), nn.Flatten(),
            nn.Dense(3, in_units=4 * 3 * 3))
    return net


def _nets(seed=0):
    jnet = _net(jgluon.nn)
    jnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = (0.3 * rng.standard_normal(p.shape)).astype(np.float32)
        p.set_data(jnd.array(a))
        arrays[name] = a
    return jnet, load_jax_params(_net(gluon.nn), arrays)


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((5, 2, 6, 6)).astype(np.float32),
            rng.randint(0, 3, 5).astype(np.int32))


@pytest.mark.parametrize("hybridize", [False, True])
def test_a_net_given_ndarrays_equals_tensors_and_jax(hybridize):
    jnet, tnet = _nets()
    x, _ = _batch()
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(nd.array(x, ctx=cpu()))
    as_tensor = tnet(torch.from_numpy(x))
    assert isinstance(got, nd.NDArray) and isinstance(as_tensor,
                                                      torch.Tensor)
    assert got.context == cpu() and got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), as_tensor.detach().numpy())
    np.testing.assert_allclose(got.asnumpy(), want, **TOL)


def test_a_tuple_output_is_wrapped_at_the_outer_call_only():
    seen = []

    class Two(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.inner = gluon.nn.Dense(2, in_units=3)

        def forward(self, x):
            h = self.inner(x)
            seen.append(type(h))
            return h, nd.relu(h) * 2

    blk = Two()
    out = blk(nd.ones((4, 3), ctx=cpu()))
    assert isinstance(out, tuple) and all(isinstance(o, nd.NDArray)
                                          for o in out)
    assert seen == [torch.Tensor]
    t = blk(torch.ones(4, 3))
    assert all(isinstance(o, torch.Tensor) for o in t)


def test_three_trainer_steps_on_ndarrays_match_jax():
    jnet, tnet = _nets(seed=2)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    jl, tl = (jgluon.loss.SoftmaxCrossEntropyLoss(),
              gluon.loss.SoftmaxCrossEntropyLoss())
    x, y = _batch()
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    for _ in range(3):
        with jautograd.record():
            jloss = jl(jnet(jnd.array(x)), jnd.array(y))
        jloss.backward()
        with cpu(), autograd.record():
            tloss = tl(tnet(nd.array(x)), nd.array(y))
        tloss.backward()
        assert isinstance(tloss, nd.NDArray)
        np.testing.assert_allclose(tloss.asnumpy(), jloss.asnumpy(), **TOL)
        # the port's Trainer drops the gradients it applied: read first
        for name, p in tp.items():
            assert isinstance(p.grad(), nd.NDArray)
            np.testing.assert_allclose(p.grad().asnumpy(),
                                       jp[name].grad().asnumpy(), **TOL)
        jtr.step(5)
        ttr.step(5)
    for name, p in tp.items():
        assert isinstance(p.data(), nd.NDArray)
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[name].data().asnumpy(), **TOL)


def test_a_write_to_data_reaches_the_next_forward():
    jnet, tnet = _nets(seed=4)
    tnet.hybridize()
    x, _ = _batch()
    jw = jnet.collect_params()[jnet[3].prefix + "weight"]
    tw = tnet.collect_params()[tnet[3].prefix + "weight"]
    tensor, epoch = tw.data().torch(), storage_epoch()
    ptr = tensor.data_ptr()
    for d in (jw.data(), tw.data()):
        d[:, :10] = 0.25
        d *= 2
        d -= d * 0.5
    jbias = jnet.collect_params()[jnet[3].prefix + "bias"]
    tbias = tnet.collect_params()[tnet[3].prefix + "bias"]
    jbias.set_data(jnd.array(np.arange(3, dtype=np.float32)))
    tbias.set_data(nd.array(np.arange(3, dtype=np.float32), ctx=cpu()))
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(nd.array(x, ctx=cpu())).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tw.data().torch() is tensor and tensor.data_ptr() == ptr
    assert storage_epoch() == epoch
    np.testing.assert_allclose(tw.data().asnumpy()[:, :10], 0.25)
    copy_ = tw.data().copy()
    copy_[:] = 7
    assert float(tw.data().asnumpy().max()) < 7


METRICS = {
    "acc": lambda m: m.Accuracy(),
    "top3": lambda m: m.TopKAccuracy(3),
    "f1": lambda m: m.F1(),
    "mcc": lambda m: m.MCC(),
    "mae": lambda m: m.MAE(),
    "mse": lambda m: m.MSE(),
    "rmse": lambda m: m.RMSE(),
    "ce": lambda m: m.CrossEntropy(),
    "nll": lambda m: m.NegativeLogLikelihood(),
    "perplexity": lambda m: m.Perplexity(ignore_label=0),
    "pearsonr": lambda m: m.PearsonCorrelation(),
    "loss": lambda m: m.Loss(),
    "composite": lambda m: m.create(["acc", "ce"]),
    "custom": lambda m: m.np(lambda l, p: float(np.abs(l - p.argmax(-1))
                                                .sum())),
}


def _metric_inputs(name):
    rng = np.random.RandomState(5)
    if name in ("f1", "mcc"):
        p = rng.rand(8, 2).astype(np.float32)
        return rng.randint(0, 2, 8).astype(np.float32), p / p.sum(-1,
                                                                  keepdims=True)
    if name in ("mae", "mse", "rmse", "pearsonr", "loss"):
        return (rng.standard_normal(8).astype(np.float32),
                rng.standard_normal(8).astype(np.float32))
    p = rng.rand(8, 5).astype(np.float32)
    return (rng.randint(0, 5, 8).astype(np.float32),
            p / p.sum(-1, keepdims=True))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_take_ndarrays(name):
    label, pred = _metric_inputs(name)
    jm, tm = METRICS[name](jmetric), METRICS[name](metric)
    for half in (slice(0, 4), slice(4, 8)):
        jm.update([jnd.array(label[half])], [jnd.array(pred[half])])
        tm.update([nd.array(label[half], ctx=cpu())],
                  [nd.array(pred[half], ctx=cpu())])
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64),
                               np.asarray(jv, np.float64), rtol=1e-6)


def _fused(seed=3):
    _, tnet = _nets(seed)
    return FusedTrainStep(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer.create("sgd", learning_rate=0.1,
                                           momentum=0.9))


def test_fused_step_and_trainloop_answer_in_ndarrays():
    x, y = _batch()
    nd_step, t_step = _fused(), _fused()
    with cpu():
        got = [nd_step(nd.array(x), nd.array(y)) for _ in range(2)]
    want = [t_step(x, y) for _ in range(2)]
    assert all(isinstance(g, nd.NDArray) and g.shape == () for g in got)
    for g, w in zip(got, want):
        assert isinstance(w, torch.Tensor)
        np.testing.assert_array_equal(g.asnumpy(), w.detach().numpy())
    xs = np.stack([x, x[::-1].copy(), x])
    ys = np.stack([y, y, y[::-1].copy()])
    with cpu():
        got_k = nd_step.run_k(nd.array(xs), nd.array(ys))
        got_list = nd_step.run_k([nd.array(a) for a in xs],
                                 [nd.array(a) for a in ys])
    want_k, want_list = t_step.run_k(xs, ys), t_step.run_k(list(xs),
                                                           list(ys))
    assert isinstance(got_k, nd.NDArray) and got_k.shape == (3,)
    np.testing.assert_array_equal(got_k.asnumpy(), want_k.numpy())
    np.testing.assert_array_equal(got_list.asnumpy(), want_list.numpy())

    loops = [TrainLoop(copy.deepcopy(_nets(6)[1]),
                       gluon.loss.SoftmaxCrossEntropyLoss(),
                       optimizer.create("sgd", learning_rate=0.05), chunk=2)
             for _ in range(2)]
    with cpu():
        chunk = loops[0].run_chunk(nd.array(xs[:2]), nd.array(ys[:2]))
        fit_nd = loops[0].fit([(nd.array(a), nd.array(b))
                               for a, b in zip(xs, ys)], steps=4)
    chunk_t = loops[1].run_chunk(xs[:2], ys[:2])
    fit_t = loops[1].fit(list(zip(xs, ys)), steps=4)
    assert isinstance(chunk, nd.NDArray) and chunk.shape == (2,)
    np.testing.assert_array_equal(chunk.asnumpy(), chunk_t.numpy())
    np.testing.assert_array_equal(fit_nd, fit_t)


def test_autograd_takes_ndarrays_and_parameters():
    _, tnet = _nets(seed=8)
    x, _ = _batch()
    w = tnet.collect_params()[tnet[3].prefix + "weight"]
    with cpu():
        xin = nd.array(x)
        xin.attach_grad()
        with autograd.record():
            out = tnet(xin)
        gx, gw = autograd.grad([out], [xin, w], head_grads=[nd.ones_like(
            out)], retain_graph=True)
        assert isinstance(gx, nd.NDArray) and isinstance(gw, nd.NDArray)
        autograd.backward([out], [nd.ones_like(out)])
        np.testing.assert_allclose(xin.grad.asnumpy(), gx.asnumpy(), **TOL)
        np.testing.assert_allclose(w.grad().asnumpy(), gw.asnumpy(), **TOL)
        v, buf = nd.array(np.ones(3, np.float32)), nd.zeros((3,))
        autograd.mark_variables([v], [buf], "add")
        for _ in range(2):
            with autograd.record():
                (v * v * 3).sum().backward()
        np.testing.assert_allclose(buf.asnumpy(), 12.0)


def _minimal_flow(M, A, x):
    """MXNet's imperative quick start (attach_grad, record, nd.dot), with
    a fixed input: the loss after each of four steps."""
    x = M.array(x)
    w = M.zeros((4,))
    w.attach_grad()
    losses = []
    for _ in range(4):
        with A.record():
            loss = ((M.dot(x, w) - 1.0) ** 2).mean()
        loss.backward()
        w[:] = w - 0.1 * w.grad
        losses.append(float(loss.asscalar()))
    return losses, w.asnumpy()


def test_the_minimal_user_flow_matches_jax():
    x = np.random.RandomState(9).rand(64, 4).astype(np.float32)
    with mx.cpu():
        want = _minimal_flow(jnd, jautograd, x)
    with cpu():
        got = _minimal_flow(nd, autograd, x)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[0][-1] < 0.5 * got[0][0]


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_a_write_to_grad_before_any_backward_is_kept(grad_req):
    # p.grad()[:] = v and p.grad() += 1 before the first backward are read
    # back in both packages. The backward then overwrites them ("write"),
    # or adds to them ("add", MXNet's meaning: the gradient accumulates
    # into the array the user sees); the JAX package's first "add"
    # backward starts from zeros instead, so there the port is held to
    # v + 1 plus the JAX gradient (1e-5)
    jnet, tnet = _nets(seed=6)
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    rng = np.random.RandomState(7)
    written = {}
    for name, p in tp.items():
        jp[name].grad_req = p.grad_req = grad_req
        v = rng.standard_normal(p.shape).astype(np.float32)
        for q, lib in ((jp[name], jnd), (p, nd)):
            g = q.grad()
            g[:] = lib.array(v, ctx=mx.cpu() if lib is jnd else cpu())
            g += 1
        np.testing.assert_array_equal(p.grad().asnumpy(), v + 1)
        np.testing.assert_array_equal(jp[name].grad().asnumpy(), v + 1)
        written[name] = v + 1 if grad_req == "add" else 0
    x, _ = _batch()
    with jautograd.record():
        jloss = jnet(jnd.array(x)).sum()
    jloss.backward()
    with cpu(), autograd.record():
        tloss = tnet(nd.array(x)).sum()
    tloss.backward()
    for name, p in tp.items():
        np.testing.assert_allclose(p.grad().asnumpy(),
                                   written[name] + jp[name].grad().asnumpy(),
                                   **TOL)
