"""The port's other twelve optimizer rules against the JAX package's.

- Three ``gluon.Trainer`` steps of each rule on ``test_torch_training``'s
  small Dense network, from the same numpy weights and batches on both
  sides: loss and every weight after each step, f32, 1e-5 (the rules'
  arithmetic in another order).
- Multi-precision: three updates of bf16 weights with the same bf16
  gradients through the JAX optimizer and the port's Trainer; the f32
  masters and states 1e-5 of their largest value (the same f32 rule, its
  operations ordered differently; FTRL's and FTML's divisions carry it
  past 1e-6), the bf16 weight the master rounded.
- Each rule with ``lr``, ``wd`` and ``t`` given as 0-d tensors (as the
  captured train step gives them) against the same rule with Python
  numbers: 1e-6 of the largest value (f32 powers in place of f64 ones).
- LAMB and LARS on a zero gradient: a trust ratio of one, as in
  ``tests/test_optimizer.py``.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import autograd, gluon, optimizer
from test_torch_training import _nets

RULES = [
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("signum", {"learning_rate": 0.01, "wd": 1e-3, "wd_lh": 0.05}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}),
    ("adadelta", {"wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "wd": 1e-3}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "bias_correction": False,
              "lower_bound": 0.5, "upper_bound": 2.0}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nadam", {"learning_rate": 0.01}),
    ("ftml", {"learning_rate": 0.01, "wd": 1e-3}),
    ("lars", {"learning_rate": 0.1, "wd": 1e-3, "eta": 0.01}),
]
IDS = [f"{r}-{i}" for i, (r, _) in enumerate(RULES)]


def test_every_rule_of_the_jax_package_but_sgld_is_registered():
    # SGLD, the last rule, is registered too now (its tests:
    # test_torch_random.py)
    want = {"sgd", "nag", "signum", "adam", "adamw", "adagrad", "adadelta",
            "rmsprop", "ftrl", "lamb", "dcasgd", "adamax", "nadam", "ftml",
            "lars", "sgld"}
    assert want == set(optimizer._REGISTRY)
    for name in want:
        j, t = mx.optimizer.create(name), optimizer.create(name)
        assert t.lr == j.lr, name          # the same default learning rate


@pytest.mark.parametrize("rule,params", RULES, ids=IDS)
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
        np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                   rtol=1e-5, atol=1e-5)
        for name, p in tnet.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), jp[name].data().asnumpy(), rtol=1e-5,
                atol=1e-5, err_msg=f"{rule} step {step} {name}")
    assert ttr.optimizer.num_update == 3 == jtr.optimizer.num_update


@pytest.mark.parametrize("rule,params", RULES, ids=IDS)
def test_multi_precision_three_steps_match_jax_masters(rule, params):
    rng = np.random.RandomState(3)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]

    jopt = mx.optimizer.create(rule, multi_precision=True, **params)
    jw = nd.array(w0).astype("bfloat16")
    jstate = jopt.create_state_multi_precision(0, jw._data)
    for g in grads:
        jstate = jopt.update(0, jw, nd.array(g).astype("bfloat16"), jstate)

    w = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    tr = gluon.Trainer([w], rule, dict(params, multi_precision=True))
    for g in grads:
        w.grad = torch.from_numpy(g).to(torch.bfloat16)
        tr.step(1)
    state = tr._states[0]
    assert w.dtype == torch.bfloat16 and state[0].dtype == torch.float32
    assert len(state) == len(jstate)
    for s, js in zip(state, jstate):
        js = np.asarray(js)
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-5,
                                   atol=1e-5 * np.abs(js).max(),
                                   err_msg=rule)
    assert torch.equal(w.detach(), state[0].to(torch.bfloat16))


def _run_fused(rule, params, tensors, steps=3):
    """`steps` calls of ``update_fused`` on two weights (one with an
    lr_mult of 2) from fixed gradients, with lr, wd and t as 0-d tensors
    or as Python numbers; returns the weights and states."""
    rng = np.random.RandomState(11)
    ws = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in ((4, 3), (5,))]
    opt = optimizer.create(rule, **params)
    states = optimizer.pack_states(
        [opt.create_state_multi_precision(i, w) for i, w in enumerate(ws)])
    lr, wd = opt.learning_rate, opt.wd
    for t in range(1, steps + 1):
        gs = [torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
              for w in ws]
        args = (lr, wd, t)
        if tensors:
            args = tuple(torch.tensor(float(a)) for a in args)
        opt.update_fused(ws, gs, states, *args, [1.0, 2.0], [1.0, 0.5])
    return ws, states


@pytest.mark.parametrize("rule,params",
                         RULES + [("sgd", {"momentum": 0.9, "wd": 1e-3}),
                                  ("adam", {"wd": 1e-3}),
                                  ("adamw", {"wd": 0.05})],
                         ids=IDS + ["sgd", "adam", "adamw"])
def test_tensor_lr_wd_and_t_match_python_numbers(rule, params):
    got_w, got_s = _run_fused(rule, params, tensors=True)
    want_w, want_s = _run_fused(rule, params, tensors=False)
    for got, want in zip(got_w + [s for st in got_s for s in st],
                         want_w + [s for st in want_s for s in st]):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(scale, 1e-30),
                                   err_msg=rule)


def test_update_fused_applies_the_multipliers_and_counts_nothing():
    """lr * lr_mult and wd * wd_mult per parameter, as the JAX fused step
    does; num_update and the per-index counts stay where they were."""
    w = [torch.ones(3), torch.ones(3)]
    opt = optimizer.create("sgd", learning_rate=0.1, wd=0.5)
    opt.update_fused(w, [torch.ones(3), torch.ones(3)], [(), ()],
                     torch.tensor(0.1), torch.tensor(0.5), torch.tensor(1.0),
                     [1.0, 2.0], [1.0, 0.0])
    np.testing.assert_allclose(w[0].numpy(), 1 - 0.1 * (1 + 0.5))
    np.testing.assert_allclose(w[1].numpy(), 1 - 0.2 * 1.0)
    assert opt.num_update == 0 and opt._index_update_count == {}


@pytest.mark.parametrize("rule,params,want", [
    ("lamb", {"learning_rate": 0.1, "beta1": 0.0, "beta2": 0.0,
              "bias_correction": False}, 2.0),
    ("lars", {"learning_rate": 0.1, "momentum": 0.0}, 2.0),
])
def test_trust_ratio_is_one_on_a_zero_gradient(rule, params, want):
    """A zero gradient gives a zero step norm: the ratio falls back to 1
    and the weight keeps its value, on both sides."""
    for tensors in (False, True):
        w = torch.full((1,), 2.0)
        opt = optimizer.create(rule, **params)
        state = opt.create_state(0, w)
        lr, t = (torch.tensor(0.1), torch.tensor(1.0)) if tensors else (
            0.1, 1)
        opt.update_fused([w], [torch.zeros(1)], [state], lr, 0.0, t, [1.0],
                         [1.0])
        np.testing.assert_allclose(w.numpy(), [want])
    jopt = mx.optimizer.create(rule, **params)
    jw = nd.array([2.0])
    jopt.update(0, jw, nd.array([0.0]), jopt.create_state(0, jw._data))
    np.testing.assert_allclose(jw.asnumpy(), [want])
