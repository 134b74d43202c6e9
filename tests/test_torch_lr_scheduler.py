"""The port's learning-rate schedulers against the JAX package's.

- The host schedule, ``scheduler(t)`` for t = 0..40 in turn (FactorScheduler
  and MultiFactorScheduler advance their state as they go), each stock
  scheduler with linear and constant warmup: equal to the JAX package's
  to 1e-12 (the same f64 arithmetic).
- ``as_torch()``: the closed form on a 0-d f32 tensor against the host
  schedule at every t, 1e-6 relative (f32 against f64), built at the start
  and mid-run (the stateful schedules' handoff), and against the JAX
  package's ``as_jax``; a custom subclass has none.
- An optimizer's ``learning_rate`` becomes its scheduler's ``base_lr``,
  and a Trainer step reads the schedule (JAX's
  ``test_optimizer_with_scheduler_in_trainer``, on both sides).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.optimizer import lr_scheduler as jlrs
from incubator_mxnet_tpu_torch import autograd, gluon, optimizer
from incubator_mxnet_tpu_torch import lr_scheduler as lrs

CASES = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=1.0)),
    ("MultiFactorScheduler", dict(step=[5, 12, 30], factor=0.3,
                                  base_lr=1.0)),
    ("PolyScheduler", dict(max_update=35, base_lr=1.0, pwr=2,
                           final_lr=0.01)),
    ("CosineScheduler", dict(max_update=35, base_lr=1.0, final_lr=0.05)),
    ("LinearScheduler", dict(max_update=35, base_lr=1.0, final_lr=0.1)),
]
WARMUPS = [{}, dict(warmup_steps=4, warmup_begin_lr=0.1),
           dict(warmup_steps=4, warmup_begin_lr=0.2,
                warmup_mode="constant")]
GRID = [(name, kw, w) for name, kw in CASES for w in WARMUPS]
IDS = [f"{name}-{i}" for name, _, _ in GRID[::3] for i in range(3)]
TS = range(0, 41)


def both(name, kw, warm):
    return (getattr(lrs, name)(**kw, **warm),
            getattr(jlrs, name)(**kw, **warm))


@pytest.mark.parametrize("name,kw,warm", GRID, ids=IDS)
def test_host_schedule_matches_jax(name, kw, warm):
    port, jax = both(name, kw, warm)
    got = [port(t) for t in TS]
    want = [jax(t) for t in TS]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if name in ("FactorScheduler", "MultiFactorScheduler"):
        state = ("count" if name == "FactorScheduler" else "cur_step_ind")
        assert getattr(port, state) == getattr(jax, state)
        assert port.base_lr == jax.base_lr


def closed(fn, t):
    return float(fn(torch.tensor(float(t))))


@pytest.mark.parametrize("name,kw,warm", GRID, ids=IDS)
def test_closed_form_matches_the_host_schedule(name, kw, warm):
    host, _ = both(name, kw, warm)
    fn = both(name, kw, warm)[0].as_torch()
    for t in TS:
        want = host(t)
        np.testing.assert_allclose(closed(fn, t), want, rtol=1e-6,
                                   atol=1e-9, err_msg=f"t={t}")


@pytest.mark.parametrize("name,kw", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_closed_form_hands_off_mid_run(name, kw):
    """Built after the host schedule has run to t = 15 (its state moved:
    the count, the index and base_lr), the closed form still gives the
    host's values from there on."""
    host, _ = both(name, kw, {})
    ref, _ = both(name, kw, {})
    for t in range(16):
        host(t)
    fn = host.as_torch()
    for t in range(15, 41):
        np.testing.assert_allclose(closed(fn, t), ref(t), rtol=1e-6,
                                   err_msg=f"t={t}")


@pytest.mark.parametrize("name,kw,warm", GRID[::2], ids=IDS[::2])
def test_closed_form_matches_jax_closed_form(name, kw, warm):
    port, jax = both(name, kw, warm)
    fn, jfn = port.as_torch(), jax.as_jax()
    got = [closed(fn, t) for t in TS]
    want = [float(jfn(np.float32(t))) for t in TS]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_closed_form_reads_nothing_back_and_a_custom_schedule_has_none():
    class Custom(lrs.LRScheduler):
        def __call__(self, num_update):
            return self.base_lr / (1 + num_update)

    assert Custom().as_torch() is None
    assert Custom(base_lr=2.0)(1) == 1.0
    fn = lrs.MultiFactorScheduler(step=[2, 4], factor=0.5).as_torch()
    out = fn(torch.tensor(3.0))
    assert isinstance(out, torch.Tensor) and out.shape == ()
    assert out.dtype == torch.float32


def test_learning_rate_becomes_the_schedulers_base():
    """The JAX package's rule: learning_rate replaces base_lr (default
    0.01 when not given); warmup_final_lr keeps the construction value."""
    for mod, sched in ((optimizer, lrs), (mx.optimizer, jlrs)):
        o = mod.create("sgd", lr_scheduler=sched.FactorScheduler(
            step=10, base_lr=2.0))
        assert o.learning_rate == 0.01
        o = mod.create("sgd", learning_rate=0.2, lr_scheduler=sched.
                       FactorScheduler(step=2, factor=0.5))
        o.num_update = 1
        assert abs(o.learning_rate - 0.2) < 1e-12
        o.num_update = 3
        assert abs(o.learning_rate - 0.1) < 1e-12
        w = sched.CosineScheduler(max_update=20, base_lr=1.0,
                                  warmup_steps=4)
        o = mod.create("sgd", learning_rate=0.5, lr_scheduler=w)
        assert w.base_lr == 0.5 and w.warmup_final_lr == 1.0


def test_optimizer_with_scheduler_in_trainer():
    """One Trainer step under FactorScheduler(step=1, factor=0.1) on both
    sides: the same weight after it."""
    jw = jgluon.Parameter("w", shape=(1,), init="ones")
    jw.initialize()
    jtr = jgluon.Trainer({"w": jw}, "sgd", {
        "lr_scheduler": jlrs.FactorScheduler(step=1, factor=0.1,
                                             base_lr=1.0),
        "learning_rate": 1.0})
    w = torch.nn.Parameter(torch.ones(1))
    tr = gluon.Trainer({"w": w}, "sgd", {
        "lr_scheduler": lrs.FactorScheduler(step=1, factor=0.1, base_lr=1.0),
        "learning_rate": 1.0})
    for _ in range(3):
        with jautograd.record():
            (jw.data() * 1.0).sum().backward()
        jtr.step(1)
        with autograd.record():
            autograd.backward((w * 1.0).sum())
        tr.step(1)
        np.testing.assert_allclose(w.detach().numpy(),
                                   jw.data().asnumpy(), rtol=1e-6)
    assert np.isfinite(w.detach().numpy()).all()
    assert tr.learning_rate == jtr.learning_rate
