"""The port's ``amp`` and multi-precision optimizers against the JAX
package's.

Each case of ``tests/test_amp.py`` runs on both sides from the same numpy
weights and batch (a Dense(1) regression), and the port's weights are held
against the JAX package's after the same steps; the port's own invariants
(an overflowed step leaves weights, masters and states bit-unchanged; the
dynamic scaler's state lives on the parameters' device) are checked on
top. Multi-precision ``sgd``/``adam``/``adamw`` run three steps on bf16
weights with the same bf16 gradients through the JAX optimizer and the
port's Trainer.

Tolerances: f32 weights 1e-5 relative (the rules' arithmetic in another
order); f32 masters and states 1e-6 relative to their largest value (the
same f32 rule, its operations fused differently); bf16 weights one bf16
step (a master on a rounding boundary may round either way); results of
bf16 forwards 2e-2 of the largest value.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import amp, autograd, gluon
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-6)


def data():
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype(np.float32)
    ys = xs @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    arrays = {"weight": (0.1 * rng.randn(1, 4)).astype(np.float32),
              "bias": np.zeros(1, np.float32)}
    return xs, ys, arrays


def jax_toy(dtype=None):
    xs, ys, arrays = data()
    net = jgluon.nn.Dense(1, in_units=4)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(arrays[name]))
    x, y = nd.array(xs), nd.array(ys)
    if dtype:
        net.cast(dtype)
        x, y = x.astype(dtype), y.astype(dtype)
    return net, x, y


def port_toy(dtype=None):
    xs, ys, arrays = data()
    net = load_jax_params(tnn.Dense(1, in_units=4), arrays)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    if dtype:
        net.to(getattr(torch, dtype))
        x, y = x.to(net.weight.dtype), y.to(net.weight.dtype)
    return net, x, y


def l2(pred, label):
    """gluon.loss.L2Loss: half the squared error, averaged per sample."""
    return (0.5 * (label - pred) ** 2).mean(dim=1)


def jweights(net):
    return np.asarray(net.weight.data()._data.astype("float32"))


def tweights(net):
    return net.weight.detach().float().numpy()


def run_jax(steps, scaler=None, opt=None, use_update=False, dtype=None,
            losses=None):
    net, x, y = jax_toy(dtype)
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        dict(opt or {"learning_rate": 0.1}))
    if scaler is not None:
        jamp.init_trainer(tr, scaler)
    L = jgluon.loss.L2Loss()
    for _ in range(steps):
        with jautograd.record():
            loss = L(net(x), y)
            if scaler is not None:
                with jamp.scale_loss(loss, tr) as sl:
                    sl.backward()
            else:
                loss.backward()
        if use_update:
            tr.allreduce_grads()
            tr.update(16)
        else:
            tr.step(16)
        if losses is not None:
            losses.append(float(loss.asnumpy().astype(np.float32).mean()))
    return net, tr


def run_port(steps, scaler=None, opt=None, use_update=False, dtype=None,
             losses=None):
    net, x, y = port_toy(dtype)
    tr = gluon.Trainer(net, "sgd", dict(opt or {"learning_rate": 0.1}))
    if scaler is not None:
        amp.init_trainer(tr, scaler)
    for _ in range(steps):
        with autograd.record():
            loss = l2(net(x), y)
            if scaler is not None:
                with amp.scale_loss(loss, tr) as sl:
                    autograd.backward(sl)
            else:
                autograd.backward(loss)
        if use_update:
            tr.allreduce_grads()
            tr.update(16)
        else:
            tr.step(16)
        if losses is not None:
            losses.append(float(loss.detach().float().mean()))
    return net, tr


def test_amp_init_sets_dtype():
    amp.init()
    assert amp.target_dtype() == "bfloat16"
    amp.init("float16")
    assert amp.target_dtype() == "float16"
    amp.init("bfloat16")
    with pytest.raises(ValueError, match="bfloat16"):
        amp.init("int8")


def test_scaled_training_matches_unscaled_and_jax():
    """Static scale S: scaled loss + unscale-in-step == vanilla training,
    and both sides agree."""
    scaled, _ = run_port(5, amp.LossScaler(init_scale=128.0))
    plain, _ = run_port(5)
    np.testing.assert_allclose(tweights(scaled), tweights(plain), **F32)
    jnet, _ = run_jax(5, jamp.LossScaler(init_scale=128.0))
    np.testing.assert_allclose(tweights(scaled), jweights(jnet), **F32)


def test_dynamic_scaler_backoff_and_growth():
    for mod in (amp, jamp):
        s = mod.DynamicLossScaler(init_scale=1024.0, growth_interval=3)
        s.update(overflow=True)
        assert s.loss_scale == 512.0
        for _ in range(3):
            s.update(overflow=False)
        assert s.loss_scale == 1024.0
        s = mod.DynamicLossScaler(init_scale=1.5)
        s.update(overflow=True)
        assert s.loss_scale == 1.0          # floored at one


def _poison(net):
    net.weight.grad.mul_(float("inf"))


def test_overflow_skips_update_bit_exactly():
    net, x, y = port_toy()
    tr = gluon.Trainer(net, "sgd", {"learning_rate": 0.1})
    scaler = amp.DynamicLossScaler(init_scale=1024.0)
    amp.init_trainer(tr, scaler)
    w0 = net.weight.detach().clone()
    with autograd.record():
        autograd.backward(l2(net(x), y))
    _poison(net)
    tr.step(16)
    assert torch.equal(net.weight.detach(), w0)
    assert scaler.loss_scale == 512.0
    # the JAX package does the same
    jnet, jx, jy = jax_toy()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    jscaler = jamp.DynamicLossScaler(init_scale=1024.0)
    jamp.init_trainer(jtr, jscaler)
    with jautograd.record():
        jgluon.loss.L2Loss()(jnet(jx), jy).backward()
    g = jnet.weight.grad()
    g._data = (g._data * np.inf).astype(g._data.dtype)
    jtr.step(16)
    np.testing.assert_array_equal(jweights(jnet), w0.numpy())
    assert jscaler.loss_scale == 512.0


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_overflow_leaves_bf16_weights_masters_and_states_unchanged(rule):
    """A clean step creates the masters and states; an overflowed one
    selects every weight, master and state back, bit for bit, on the
    device, and the next clean step matches the JAX package's."""
    opt = {"learning_rate": 0.05, "multi_precision": True}
    if rule == "sgd":
        opt["momentum"] = 0.9
    net, x, y = port_toy("bfloat16")
    tr = gluon.Trainer(net, rule, dict(opt))
    scaler = amp.DynamicLossScaler(init_scale=256.0)
    amp.init_trainer(tr, scaler)
    jnet, jx, jy = jax_toy("bfloat16")
    jtr = jgluon.Trainer(jnet.collect_params(), rule, dict(opt))
    jscaler = jamp.DynamicLossScaler(init_scale=256.0)
    jamp.init_trainer(jtr, jscaler)

    def port_step(poison=False):
        with autograd.record():
            with amp.scale_loss(l2(net(x), y), tr) as sl:
                autograd.backward(sl)
        if poison:
            _poison(net)
        tr.step(16)

    def jax_step(poison=False):
        with jautograd.record():
            with jamp.scale_loss(jgluon.loss.L2Loss()(jnet(jx), jy),
                                 jtr) as sl:
                sl.backward()
        if poison:
            g = jnet.weight.grad()
            g._data = (g._data * np.inf).astype(g._data.dtype)
        jtr.step(16)

    port_step()
    jax_step()
    snap = [t.clone() for t in list(net.parameters())
            + [s for st in tr._states for s in st]]
    assert all(st[0].dtype == torch.float32 for st in tr._states)
    port_step(poison=True)
    jax_step(poison=True)
    after = list(net.parameters()) + [s for st in tr._states for s in st]
    assert all(torch.equal(a, b) for a, b in zip(after, snap))
    assert scaler.loss_scale == jscaler.loss_scale == 128.0
    port_step()
    jax_step()
    for i in range(len(tr._states)):
        # gradients of bf16 forwards on both sides: 2e-2 of the largest
        want = np.asarray(jtr._states[i][0]).astype(np.float32)
        np.testing.assert_allclose(tr._states[i][0].numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_static_scaler_skips_an_overflow_and_trains_on(dtype):
    """A static LossScaler's overflowed step calls no update, as the JAX
    package's static path branches on the host: the weights, masters and
    states stay, the poisoned gradients are dropped (the next backward
    writes afresh), and the clean steps after it match the JAX
    package's."""
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    if dtype:
        opt["multi_precision"] = True
    net, x, y = port_toy(dtype)
    tr = gluon.Trainer(net, "sgd", dict(opt))
    amp.init_trainer(tr, amp.LossScaler(init_scale=128.0))
    jnet, jx, jy = jax_toy(dtype)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    jamp.init_trainer(jtr, jamp.LossScaler(init_scale=128.0))
    for step in range(4):
        poison = step == 1
        with autograd.record():
            with amp.scale_loss(l2(net(x), y), tr) as sl:
                autograd.backward(sl)
        if poison:
            _poison(net)
            snap = [t.clone() for t in list(net.parameters())
                    + [s for st in tr._states for s in st]]
        tr.step(16)
        if poison:
            after = (list(net.parameters())
                     + [s for st in tr._states for s in st])
            assert all(torch.equal(a, b) for a, b in zip(after, snap))
            assert all(p.grad is None for p in net.parameters())
        with jautograd.record():
            with jamp.scale_loss(jgluon.loss.L2Loss()(jnet(jx), jy),
                                 jtr) as sl:
                sl.backward()
        if poison:
            g = jnet.weight.grad()
            g._data = (g._data * np.inf).astype(g._data.dtype)
        jtr.step(16)
    assert tr._amp_loss_scaler.loss_scale == 128.0
    if dtype is None:
        np.testing.assert_allclose(tweights(net), jweights(jnet), **F32)
    else:
        for i in range(len(tr._states)):
            # gradients of bf16 forwards on both sides: 2e-2 of the largest
            want = np.asarray(jtr._states[i][0]).astype(np.float32)
            np.testing.assert_allclose(tr._states[i][0].numpy(), want,
                                       rtol=0,
                                       atol=2e-2 * np.abs(want).max())


def test_static_scaler_overflow_leaves_adams_count_alone():
    """Adam under a static LossScaler: a poisoned first step, then three
    clean ones. The overflowed step is no update on either side, so Adam's
    t counts the clean steps only, and the weights and states after them
    are the JAX package's (its bias correction would differ at every step
    had the skip counted)."""
    opt = {"learning_rate": 0.05}
    net, x, y = port_toy()
    tr = gluon.Trainer(net, "adam", dict(opt))
    amp.init_trainer(tr, amp.LossScaler(init_scale=128.0))
    jnet, jx, jy = jax_toy()
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", dict(opt))
    jamp.init_trainer(jtr, jamp.LossScaler(init_scale=128.0))
    w0 = net.weight.detach().clone()
    for step in range(4):
        poison = step == 0
        with autograd.record():
            with amp.scale_loss(l2(net(x), y), tr) as sl:
                autograd.backward(sl)
        if poison:
            _poison(net)
        tr.step(16)
        with jautograd.record():
            with jamp.scale_loss(jgluon.loss.L2Loss()(jnet(jx), jy),
                                 jtr) as sl:
                sl.backward()
        if poison:
            g = jnet.weight.grad()
            g._data = (g._data * np.inf).astype(g._data.dtype)
        jtr.step(16)
        if poison:
            assert torch.equal(net.weight.detach(), w0)
            assert tr.optimizer.num_update == jtr.optimizer.num_update == 0
    assert tr.optimizer.num_update == jtr.optimizer.num_update == 3
    assert (tr.optimizer._index_update_count
            == jtr.optimizer._index_update_count == {0: 3, 1: 3})
    np.testing.assert_allclose(tweights(net), jweights(jnet), **F32)
    for st, jst in zip(tr._states, jtr._states):
        for s, js in zip(st, jst):
            js = np.asarray(js)
            # f32 states: 1e-6 of their largest value
            np.testing.assert_allclose(s.numpy(), js, rtol=1e-6,
                                       atol=1e-6 * np.abs(js).max())


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_trainer_packs_states_into_one_buffer(rule):
    """Masters and states are views of one f32 buffer (one snapshot and
    one select for a skipped step), and the update on them is bit for bit
    the update on separate tensors."""
    opt = {"learning_rate": 0.05, "multi_precision": True}
    if rule == "sgd":
        opt["momentum"] = 0.9
    net, x, y = port_toy("bfloat16")
    tr = gluon.Trainer(net, rule, dict(opt))
    params = list(net.parameters())
    loose = gluon.Trainer(params, rule, dict(opt)).optimizer
    ws = [p.detach().clone() for p in params]
    sts = [loose.create_state_multi_precision(i, w)
           for i, w in enumerate(ws)]
    for _ in range(3):
        with autograd.record():
            autograd.backward(l2(net(x), y))
        grads = [p.grad.clone() for p in params]
        tr.step(16)
        loose.rescale_grad = 1.0 / 16
        sts = loose.update_multi([0, 1], ws, grads, sts)
    flat = [s for st in tr._states for s in st]
    base = flat[0]._base
    assert base is not None and base.dtype == torch.float32
    assert all(s._base is base for s in flat)
    assert base.numel() == sum(s.numel() for s in flat)
    assert all(sep._base is None for st in sts for sep in st)
    for st, sep in zip(tr._states, sts):
        assert all(torch.equal(a, b) for a, b in zip(st, sep))
    assert all(torch.equal(p.detach(), w) for p, w in zip(params, ws))


def test_bf16_cast_training_converges_like_jax():
    """bf16 params + multi_precision masters still learn, as in the JAX
    package; the two loss curves agree to bf16 precision."""
    opt = {"learning_rate": 0.5, "multi_precision": True}
    losses, jlosses = [], []
    net, tr = run_port(40, opt=opt, dtype="bfloat16", losses=losses)
    run_jax(40, opt=opt, dtype="bfloat16", losses=jlosses)
    assert net.weight.dtype == torch.bfloat16
    assert tr._states[0][0].dtype == torch.float32
    assert losses[-1] < losses[0] * 0.7, losses
    # bf16 forwards on both sides: 2e-2 of the first loss
    np.testing.assert_allclose(losses, jlosses, rtol=0,
                               atol=2e-2 * jlosses[0])


def test_unscale_explicit():
    net, x, y = port_toy()
    tr = gluon.Trainer(net, "sgd")
    amp.init_trainer(tr, amp.LossScaler(init_scale=64.0))
    with autograd.record():
        with amp.scale_loss(l2(net(x), y), tr) as sl:
            autograd.backward(sl)
    g_scaled = net.weight.grad.clone()
    amp.unscale(tr)
    np.testing.assert_allclose(net.weight.grad.numpy(),
                               g_scaled.numpy() / 64.0, rtol=1e-6)
    # scaler state preserved; the following step must not unscale again
    assert tr._amp_loss_scaler.loss_scale == 64.0
    w_before = net.weight.detach().clone()
    g_unscaled = net.weight.grad.clone()
    tr.step(1)
    expected = w_before - 0.01 * g_unscaled  # sgd default lr, scale 1.0
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               expected.numpy(), rtol=1e-5, atol=1e-7)
    assert not tr._amp_unscaled  # flag consumed
    # the JAX package from the same weights
    jnet, jx, jy = jax_toy()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd")
    jamp.init_trainer(jtr, jamp.LossScaler(init_scale=64.0))
    with jautograd.record():
        with jamp.scale_loss(jgluon.loss.L2Loss()(jnet(jx), jy), jtr) as sl:
            sl.backward()
    jamp.unscale(jtr)
    jtr.step(1)
    np.testing.assert_allclose(tweights(net), jweights(jnet), **F32)


def test_unscale_with_a_dynamic_scaler_then_step():
    """unscale() divides by the device scale; the step then skips its own
    unscale, and both sides agree."""
    net, x, y = port_toy()
    tr = gluon.Trainer(net, "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr, amp.DynamicLossScaler(init_scale=32.0))
    jnet, jx, jy = jax_toy()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    jamp.init_trainer(jtr, jamp.DynamicLossScaler(init_scale=32.0))
    for _ in range(2):
        with autograd.record():
            with amp.scale_loss(l2(net(x), y), tr) as sl:
                autograd.backward(sl)
        amp.unscale(tr)
        tr.step(16)
        with jautograd.record():
            with jamp.scale_loss(jgluon.loss.L2Loss()(jnet(jx), jy),
                                 jtr) as sl:
                sl.backward()
        jamp.unscale(jtr)
        jtr.step(16)
    np.testing.assert_allclose(tweights(net), jweights(jnet), **F32)


def test_update_path_also_wrapped():
    """allreduce_grads() + update() must unscale like step()."""
    scaler = lambda m: m.LossScaler(init_scale=256.0)  # noqa: E731
    by_update, _ = run_port(3, scaler(amp), use_update=True)
    by_step, _ = run_port(3, scaler(amp))
    np.testing.assert_allclose(tweights(by_update), tweights(by_step),
                               rtol=1e-6)
    jnet, _ = run_jax(3, scaler(jamp), use_update=True)
    np.testing.assert_allclose(tweights(by_update), jweights(jnet), **F32)


def test_dynamic_scaler_runs_on_device():
    """The scale and the clean-step count are tensors on the parameters'
    device (no host bool in the step); growth_interval=2 and 3 clean
    steps grow the scale once, on both sides."""
    scaler = amp.DynamicLossScaler(init_scale=1024.0, growth_interval=2)
    net, _ = run_port(3, scaler)
    device = net.weight.device
    assert isinstance(scaler._scale_dev, torch.Tensor)
    assert scaler._scale_dev.device == device
    assert scaler._scale_dev.dtype == torch.float32
    assert scaler._unskipped_dev.dtype == torch.int32
    assert int(scaler._unskipped_dev) == 1
    assert scaler.loss_scale == 2048.0
    jscaler = jamp.DynamicLossScaler(init_scale=1024.0, growth_interval=2)
    jnet, _ = run_jax(3, jscaler)
    assert jscaler.loss_scale == 2048.0
    np.testing.assert_allclose(tweights(net), jweights(jnet), **F32)


def test_scale_loss_needs_init_trainer_and_scales_lists():
    net, x, y = port_toy()
    tr = gluon.Trainer(net, "sgd")
    with pytest.raises(ValueError, match="init_trainer"):
        with amp.scale_loss(torch.ones(1), tr):
            pass
    amp.init_trainer(tr, amp.LossScaler(init_scale=8.0))
    with amp.scale_loss([torch.ones(2), torch.full((1,), 2.0)], tr) as ls:
        assert isinstance(ls, list)
        assert [t.tolist() for t in ls] == [[8.0, 8.0], [16.0]]


# ---------------------------------------------------------------------------
# multi-precision optimizers
# ---------------------------------------------------------------------------

MP_RULES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.05, "clip_gradient": 0.5}),
]


def bf16_step(x):
    """One bf16 step (unit in the last place) at each |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("rule,params", MP_RULES, ids=[r for r, _ in MP_RULES])
def test_multi_precision_three_steps_match_jax(rule, params):
    rng = np.random.RandomState(len(rule))
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]

    jopt = mx.optimizer.create(rule, multi_precision=True, **params)
    jw = nd.array(w0).astype("bfloat16")
    jstate = jopt.create_state_multi_precision(0, jw._data)
    for g in grads:
        jstate = jopt.update(0, jw, nd.array(g).astype("bfloat16"), jstate)

    w = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    tr = gluon.Trainer([w], rule, dict(params, multi_precision=True))
    assert tr.optimizer.multi_precision
    for g in grads:
        w.grad = torch.from_numpy(g).to(torch.bfloat16)
        tr.step(1)
    state = tr._states[0]
    assert w.dtype == torch.bfloat16 and state[0].dtype == torch.float32
    assert len(state) == len(jstate)
    for s, js in zip(state, jstate):
        js = np.asarray(js)
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-6,
                                   atol=1e-6 * np.abs(js).max())
    want = np.asarray(jw._data.astype("float32"))
    got = w.detach().float().numpy()
    assert np.all(np.abs(got - want) <= bf16_step(want)), (got, want)
    # the weight is its master rounded to bf16
    assert torch.equal(w.detach(), state[0].to(torch.bfloat16))


def test_multi_precision_keeps_updates_below_half_a_bf16_step():
    """1e-3 steps on a weight of 1.0 (half a bf16 step there is 2**-8):
    lost without a master, accumulated with one."""
    for mp, want in ((False, 1.0), (True, 0.99)):
        w = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
        tr = gluon.Trainer([w], "sgd", {"learning_rate": 1e-3,
                                        "multi_precision": mp})
        for _ in range(10):
            w.grad = torch.ones(4, dtype=torch.bfloat16)
            tr.step(1)
        np.testing.assert_allclose(w.detach().float().numpy(), want,
                                   atol=bf16_step(np.float32(want)))
        assert len(tr._states[0]) == (1 if mp else 0)


def test_f32_weights_take_no_master():
    w = torch.nn.Parameter(torch.ones(3))
    opt = gluon.Trainer([w], "adam", {"multi_precision": True}).optimizer
    state = opt.create_state_multi_precision(0, w)
    assert len(state) == 2          # m and v, no master
    low = torch.ones(3, dtype=torch.float16)
    assert len(opt.create_state_multi_precision(0, low)) == 3
