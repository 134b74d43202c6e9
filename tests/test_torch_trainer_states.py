"""``gluon.Trainer.save_states``/``load_states`` in the JAX package's file
format, both ways.

- A round trip in the port: counts and states restored, packed, on the
  parameters' device, and the next step equal to the uninterrupted one.
- A file written by the JAX Trainer loaded into the port (and the other
  way round): two more steps on each side from there agree with the
  writer's own two more steps, weights 1e-5 (f32, the rules' arithmetic in
  another order).
- ``multi_precision``: the f32 masters survive the trip and stay f32 under
  bf16 weights.
"""
import pickle

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import autograd, gluon
from test_torch_training import _nets

RULES = [("adam", {"learning_rate": 0.01, "wd": 1e-3}),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
         ("nadam", {"learning_rate": 0.01})]
F32 = dict(rtol=1e-5, atol=1e-5)


def _batch(step):
    rng = np.random.RandomState(40 + step)
    return (rng.randn(6, 8).astype(np.float32),
            rng.randint(0, 5, 6).astype(np.int32))


def jstep(jnet, jtr, step):
    x, y = _batch(step)
    with jautograd.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(nd.array(x)), nd.array(y, dtype="int32"))
    loss.backward()
    jtr.step(6)


def tstep(tnet, ttr, step):
    x, y = _batch(step)
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(torch.from_numpy(x)), torch.from_numpy(y))
    autograd.backward(loss)
    ttr.step(6)


def jax_net(arrays):
    """The JAX side of ``_nets``, holding `arrays`."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="tanh", in_units=8),
             jgluon.nn.Dense(5, in_units=16))
    jnet.initialize(init=mx.init.Normal(0.02))
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[name]))
    return jnet


def jweights(jnet):
    return {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_prefix().items()}


def tweights(tnet):
    """Copies: ``nd.array`` of a numpy view of a parameter may share its
    memory on the CPU."""
    return {n: p.detach().float().numpy().copy()
            for n, p in tnet.named_parameters()}


@pytest.mark.parametrize("rule,params", RULES, ids=[r for r, _ in RULES])
def test_round_trip_in_the_port(rule, params, tmp_path):
    _, a = _nets(seed=2)
    _, b = _nets(seed=2)
    tra = gluon.Trainer(a, rule, dict(params))
    for s in range(2):
        tstep(a, tra, s)
    fname = tmp_path / "states"
    tra.save_states(fname)
    with open(fname, "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"num_update", "index_update_count", "states"}
    assert blob["num_update"] == 2
    assert all(isinstance(s, tuple) and all(isinstance(x, np.ndarray)
                                            for x in s)
               for s in blob["states"])
    with torch.no_grad():
        for p, q in zip(b.parameters(), a.parameters()):
            p.copy_(q)
    trb = gluon.Trainer(b, rule, dict(params))
    trb.load_states(fname)
    assert trb.optimizer.num_update == 2
    assert trb.optimizer._index_update_count == {0: 2, 1: 2, 2: 2, 3: 2}
    flat = {s._base is not None for st in trb._states for s in st}
    assert flat <= {True}           # views of one packed buffer
    tstep(a, tra, 2)
    tstep(b, trb, 2)
    for n, w in tweights(a).items():
        np.testing.assert_array_equal(tweights(b)[n], w, err_msg=n)


@pytest.mark.parametrize("rule,params", RULES, ids=[r for r, _ in RULES])
def test_a_jax_file_continues_in_the_port_as_in_jax(rule, params, tmp_path):
    jnet, tnet = _nets(seed=4)
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(params))
    for s in range(3):
        jstep(jnet, jtr, s)
    fname = tmp_path / "jax_states"
    jtr.save_states(str(fname))
    with torch.no_grad():
        for name, p in tnet.named_parameters():
            p.copy_(torch.from_numpy(jweights(jnet)[name]))
    ttr = gluon.Trainer(tnet, rule, dict(params))
    ttr.load_states(fname)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3
    for s in (3, 4):
        jstep(jnet, jtr, s)
        tstep(tnet, ttr, s)
    want = jweights(jnet)
    for n, w in tweights(tnet).items():
        np.testing.assert_allclose(w, want[n], err_msg=n, **F32)


@pytest.mark.parametrize("rule,params", RULES, ids=[r for r, _ in RULES])
def test_a_port_file_continues_in_jax_as_in_the_port(rule, params, tmp_path):
    _, tnet = _nets(seed=4)
    ttr = gluon.Trainer(tnet, rule, dict(params))
    for s in range(3):
        tstep(tnet, ttr, s)
    fname = tmp_path / "port_states"
    ttr.save_states(fname)
    jnet = jax_net(tweights(tnet))
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(params))
    jtr.load_states(str(fname))
    assert jtr.optimizer.num_update == 3
    for s in (3, 4):
        tstep(tnet, ttr, s)
        jstep(jnet, jtr, s)
    want = tweights(tnet)
    for n, w in jweights(jnet).items():
        np.testing.assert_allclose(w, want[n], err_msg=n, **F32)


def test_multi_precision_masters_are_kept(tmp_path):
    """bf16 weights under multi_precision: the file holds the f32
    masters; loaded into the port (from either package) they come back
    f32 and equal, first in each state, and the next step uses them."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    params = {"learning_rate": 0.01, "multi_precision": True}

    def port_trainer():
        w = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
        return w, gluon.Trainer([w], "adam", dict(params))

    w, tr = port_trainer()
    for g in grads[:2]:
        w.grad = torch.from_numpy(g).to(torch.bfloat16)
        tr.step(1)
    tr.save_states(tmp_path / "mp")
    w2, tr2 = port_trainer()
    with torch.no_grad():
        w2.copy_(w)
    tr2.load_states(tmp_path / "mp")
    assert tr2._states[0][0].dtype == torch.float32
    for s, t in zip(tr2._states[0], tr._states[0]):
        assert torch.equal(s, t)
    for ww, trr in ((w, tr), (w2, tr2)):
        ww.grad = torch.from_numpy(grads[2]).to(torch.bfloat16)
        trr.step(1)
    assert torch.equal(w, w2)
    assert torch.equal(tr._states[0][0], tr2._states[0][0])

    # the JAX package's multi-precision file: its master goes in first
    jp = jgluon.Parameter("w", shape=(6, 5), dtype="bfloat16")
    jp.initialize()
    jp.set_data(nd.array(w0))
    jtr = jgluon.Trainer({"w": jp}, "adam", dict(params))
    for g in grads[:2]:
        with jautograd.record():
            (jp.data().astype("float32") * nd.array(g)).sum().backward()
        jtr.step(1)
    jtr.save_states(str(tmp_path / "jmp"))
    w3, tr3 = port_trainer()
    tr3.load_states(tmp_path / "jmp")
    master = tr3._states[0][0]
    assert master.dtype == torch.float32 and len(tr3._states[0]) == 3
    np.testing.assert_allclose(master.numpy(), np.asarray(
        jtr._states[0][0]), rtol=0, atol=0)
