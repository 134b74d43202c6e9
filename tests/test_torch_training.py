"""The port's training path against the JAX package's: autograd.record /
backward, gluon.loss, the optimizers and the Trainer.

The same numpy weights and batches go to a small Dense network on both
sides, and three Trainer steps of each rule are compared, loss and weights
after every step. Each step runs a fresh backward: MXNet writes gradients
(``grad_req="write"``) where PyTorch accumulates, so a Trainer that left a
gradient behind would make the second step differ.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import autograd, gluon, optimizer, profiler
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn as tnn


def _nets(seed):
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="tanh", in_units=8),
             jgluon.nn.Dense(5, in_units=16))
    jnet.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = (0.5 * rng.randn(*p.shape)).astype(np.float32)
        p.set_data(nd.array(a))
        arrays[name] = a
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(16, activation="tanh", in_units=8),
             tnn.Dense(5, in_units=16))
    return jnet, load_jax_params(tnet, arrays)


RULES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.05, "clip_gradient": 0.05}),
]


@pytest.mark.parametrize("rule,params", RULES, ids=[r for r, _ in RULES])
def test_three_trainer_steps_match_jax(rule, params):
    jnet, tnet = _nets(seed=len(rule))
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(params))
    ttr = gluon.Trainer(tnet, rule, dict(params))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(7)
    jp = jnet._collect_params_with_prefix()
    for step in range(3):
        x = rng.randn(6, 8).astype(np.float32)
        y = rng.randint(0, 5, 6).astype(np.int32)
        with jautograd.record():
            jl = jloss_fn(jnet(nd.array(x)), nd.array(y, dtype="int32"))
        jl.backward()
        jtr.step(6)
        with autograd.record():
            tl = tloss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(tl)
        ttr.step(6)
        # f32 on both sides; the rules' arithmetic in another order: 1e-5
        np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                   rtol=1e-5, atol=1e-5)
        for name, p in tnet.named_parameters():
            assert p.grad is None
            np.testing.assert_allclose(
                p.detach().numpy(), jp[name].data().asnumpy(), rtol=1e-5,
                atol=1e-5, err_msg=f"{rule} step {step} {name}")
    assert ttr.optimizer.num_update == 3 == jtr.optimizer.num_update


def test_record_sets_training_and_backward_seeds_ones():
    assert not autograd.is_recording() and not autograd.is_training()
    w = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        loss = w * w
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    assert not autograd.is_recording() and not autograd.is_training()
    autograd.backward(loss, retain_graph=True)   # a vector: its sum
    np.testing.assert_array_equal(w.grad.numpy(), [2.0, 4.0, 6.0])
    w.grad = None
    autograd.backward([loss], [torch.tensor([1.0, 0.0, -1.0])])
    np.testing.assert_array_equal(w.grad.numpy(), [2.0, 0.0, -6.0])
    with pytest.raises(ValueError, match="head gradients"):
        autograd.backward([loss, loss], [None])


def test_backward_writes_gradients_as_jax_does():
    """``grad_req="write"``: two backwards without an update in between
    leave the second gradient on every leaf the second one reaches, on both
    sides; a leaf it does not reach keeps the first one's, and a head that
    is itself a leaf is written too."""
    jnet, tnet = _nets(seed=11)
    jp = jnet._collect_params_with_prefix()
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(5)
    batches = [(rng.randn(6, 8).astype(np.float32),
                rng.randint(0, 5, 6).astype(np.int32)) for _ in range(2)]
    for x, y in batches:
        with jautograd.record():
            jl = jloss_fn(jnet(nd.array(x)), nd.array(y, dtype="int32"))
        jl.backward()
        with autograd.record():
            tl = tloss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(tl)
    for name, p in tnet.named_parameters():
        # f32 on both sides, the sums in another order: 1e-5
        np.testing.assert_allclose(p.grad.numpy(), jp[name].grad().asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the second backward alone gives the same gradients
    want = {n: p.grad.clone() for n, p in tnet.named_parameters()}
    for p in tnet.parameters():
        p.grad = None
    x, y = batches[1]
    with autograd.record():
        autograd.backward(tloss_fn(tnet(torch.from_numpy(x)),
                                   torch.from_numpy(y)))
    for name, p in tnet.named_parameters():
        assert torch.equal(p.grad, want[name]), name

    # a leaf the heads do not reach keeps its gradient; a leaf head is
    # written, not added to
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([3.0, 4.0], requires_grad=True)
    ja, jb = nd.array([1.0, 2.0]), nd.array([3.0, 4.0])
    ja.attach_grad()
    jb.attach_grad()
    with autograd.record():
        autograd.backward(a * b)
    with jautograd.record():
        jc = ja * jb
    jc.backward()
    for _ in range(2):
        with autograd.record():
            autograd.backward(a * a)
        with jautograd.record():
            jc = ja * ja
        jc.backward()
    np.testing.assert_array_equal(b.grad.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(jb.grad.asnumpy(), [1.0, 2.0])
    autograd.backward(b, torch.tensor([5.0, 6.0]))
    jb.backward(nd.array([5.0, 6.0]))
    for t, j in ((a, ja), (b, jb)):
        np.testing.assert_array_equal(t.grad.numpy(), j.grad.asnumpy())
    np.testing.assert_array_equal(a.grad.numpy(), [2.0, 4.0])
    np.testing.assert_array_equal(b.grad.numpy(), [5.0, 6.0])


def test_dropout_follows_the_recording_scope():
    drop = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(1000)
    assert torch.equal(drop(x), x)
    with autograd.record():
        y = drop(x)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}


def test_softmax_ce_loss_matches_jax():
    rng = np.random.RandomState(3)
    pred = rng.randn(4, 3, 7).astype(np.float32)
    label = rng.randint(0, 7, (4, 3)).astype(np.int32)
    sw = rng.rand(4, 1).astype(np.float32)
    dense = rng.dirichlet(np.ones(7), (4, 3)).astype(np.float32)
    cases = [({}, (label,)), ({"weight": 0.5}, (label, sw)),
             ({"sparse_label": False}, (dense,)),
             ({"from_logits": True}, (label,)),
             ({"batch_axis": 1}, (label,))]
    for kw, extra in cases:
        ref = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)(
            nd.array(pred), *(nd.array(a) for a in extra)).asnumpy()
        out = gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
            torch.from_numpy(pred), *(torch.from_numpy(a) for a in extra))
        assert out.shape == ref.shape, kw
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5,
                                   err_msg=str(kw))


def test_trainer_collects_params_and_refuses_stale_gradients():
    _, net = _nets(seed=1)
    named = dict(net.named_parameters())
    by_dict = gluon.Trainer(named, "sgd", {"learning_rate": 0.1})
    assert by_dict._params == [named[k] for k in sorted(named)]
    tied = gluon.Trainer([net[0].weight, net[0].weight, net[1].bias], "sgd")
    assert len(tied._params) == 2
    frozen = net[1].weight
    frozen.requires_grad_(False)
    tr = gluon.Trainer(net, "sgd", {"learning_rate": 0.5})
    assert all(p is not frozen for p in tr._params)
    with pytest.raises(RuntimeError, match="ignore_stale_grad"):
        tr.step(1)
    before = net[0].weight.detach().clone()
    net[0].weight.grad = torch.ones_like(before)
    profiler.reset_counters()
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    tr.step(2, ignore_stale_grad=True)
    assert profiler.counters()["mxtpu/trainer.steps"] == 1
    np.testing.assert_allclose(net[0].weight.detach().numpy(),
                               before.numpy() - 0.25 * 0.5)
    assert net[0].weight.grad is None
    profiler.reset_counters()


def test_optimizer_registry_lr_mult_and_per_index_count():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer.create("lamb9")
    w = torch.nn.Parameter(torch.ones(3))
    w.lr_mult = 2.0
    opt = optimizer.create("SGD", learning_rate=0.1, param_dict={0: w})
    opt.update(0, w, torch.ones(3), ())
    np.testing.assert_allclose(w.detach().numpy(), [0.8] * 3)
    adam = optimizer.create("adam", learning_rate=0.1)
    x = torch.zeros(2, dtype=torch.bfloat16)
    state = adam.create_state(0, x)
    assert all(s.dtype == torch.float32 for s in state)
    adam.update(0, x, torch.tensor([1.0, -1.0]), state)
    y = torch.zeros(1)
    adam.update(1, y, torch.ones(1), adam.create_state(1, y))
    assert adam._index_update_count == {0: 1, 1: 1} and adam.num_update == 1
    # bias-corrected first step: -lr * sign(g)
    np.testing.assert_allclose(x.float().numpy(), [-0.1, 0.1], rtol=1e-2)
