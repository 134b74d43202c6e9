"""The port's ``parallel.FusedTrainStep`` and ``TrainLoop`` against the JAX
package's, on the CPU (where the step runs eagerly: a graph is captured
only on a card, and ``chip_smoke.py`` holds that path there).

- Three fused steps from the same numpy weights and batches: the small
  Dense network of ``test_torch_training`` (sgd with momentum, adam), a
  2-layer, 64-unit TransformerLM (adam under a CosineScheduler with
  warmup; the JAX side through its Pallas kernels in interpret mode) and
  the BatchNormReLU ResNet of ``test_torch_resnet`` (sgd; its moving
  statistics; the JAX side on its plain XLA path, the same function). Losses 1e-5 (the Dense net) or 1e-4 (the deeper nets) and
  weights as stated at each test: f32 sums in other orders.
- ``run_k`` against sequential calls: bit-exact at a constant lr, within
  1e-6 under a decaying schedule computed in the step or sampled on the
  host, and mixed with single steps; the lrs the steps used against the
  host schedule.
- ``TrainLoop``: the cases of ``tests/test_trainloop.py`` that hold on one
  device (fit's counts, the epoch tail dropped, ``reset()`` per epoch, an
  exhausted source, a label-less batch, steps below a chunk, the chunk's
  resolution), the arguments that are not ported yet, and
  ``ensure_built`` spending no update.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu.parallel import FusedTrainStep as JaxStep
from incubator_mxnet_tpu_torch import (TrainLoop, gluon, lr_scheduler,
                                       optimizer, profiler)
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_loss
from incubator_mxnet_tpu_torch.parallel import FusedTrainStep
from test_torch_resnet import (CLASSES, bnrelu_pair, images,
                               jax_moving_stats, port_moving_stats)
from test_torch_training import _nets

JL = jgluon.loss.SoftmaxCrossEntropyLoss()
TL = gluon.loss.SoftmaxCrossEntropyLoss()


def batches(k, seed=0, batch=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, batch, 8).astype(np.float32),
            rng.randint(0, 5, (k, batch)).astype(np.int32))


def dense_step(seed=3, **kw):
    return FusedTrainStep(_nets(seed)[1], TL, optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, **kw))


def weights(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize("rule,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
def test_three_fused_steps_match_jax_on_the_dense_net(rule, params):
    jnet, tnet = _nets(seed=3)
    jstep = JaxStep(jnet, JL, mx.optimizer.create(rule, **params))
    tstep = FusedTrainStep(tnet, TL, optimizer.create(rule, **params))
    xs, ys = batches(3)
    for x, y in zip(xs, ys):
        jl = jstep(nd.array(x), nd.array(y, dtype="int32")).asnumpy()
        tl = tstep(x, y)
        assert tl.shape == () and tl.device.type == "cpu"
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert tstep.optimizer.num_update == 3 == jstep.optimizer.num_update


def test_three_fused_steps_of_the_lm_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    cfg = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
               max_length=32)
    jnet = JaxLM(97, **cfg)
    jnet.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(0)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(np.float32)
        a = a + 1.0 if name.endswith("gamma") else a
        p.set_data(nd.array(a))
        arrays[name] = a
    tnet = load_jax_params(TransformerLM(97, **cfg), arrays)

    def opt(mod, sched):
        return mod.create("adam", learning_rate=1e-3, lr_scheduler=sched.
                          CosineScheduler(max_update=10, base_lr=1e-3,
                                          warmup_steps=2,
                                          warmup_begin_lr=1e-4))
    jstep = JaxStep(jnet, jax_lm_loss, opt(mx.optimizer, mx.lr_scheduler))
    tstep = FusedTrainStep(tnet, lm_loss, opt(optimizer, lr_scheduler))
    ids = rng.randint(0, 97, (3, 2, 24)).astype(np.int32)
    for x in ids:
        jl = jstep(nd.array(x, dtype="int32"),
                   nd.array(x, dtype="int32")).asnumpy()
        tl = tstep(torch.from_numpy(x), torch.from_numpy(x))
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4)
    jp = jnet._collect_params_with_prefix()
    lr_sum = sum(tstep.optimizer.lr_scheduler(t) for t in (1, 2, 3))
    for name, p in tnet.named_parameters():
        w, wj = p.detach().numpy(), jp[name].data().asnumpy()
        # Adam steps +-lr per element wherever a gradient is roundoff
        # (the key bias's is 0 in exact arithmetic); elsewhere f32 sums
        np.testing.assert_array_less(np.abs(w - wj), 2 * lr_sum + 1e-6,
                                     err_msg=name)
        if not name.endswith("qkv.bias"):
            np.testing.assert_allclose(w, wj, rtol=0, atol=2e-5,
                                       err_msg=name)


def test_three_fused_steps_move_the_moving_statistics_as_jax():
    """Batches of 16: at 4 the last stage's BatchNorm normalizes four
    values a channel, and three steps of either package's eager Trainer
    already part by 0.4%."""
    jnet, tnet, _ = bnrelu_pair(seed=5)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jstep = JaxStep(jnet, JL, mx.optimizer.create("sgd", **opt))
    tstep = FusedTrainStep(tnet, TL, optimizer.create("sgd", **opt))
    rng = np.random.RandomState(7)
    for i in range(3):
        x = images(16, 6 + i)
        y = rng.randint(0, CLASSES, 16).astype(np.int32)
        jl = jstep(nd.array(x), nd.array(y, dtype="int32")).asnumpy()
        tl = tstep(x, y)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4)
    want = jax_moving_stats(jnet)
    stats = port_moving_stats(tnet)
    assert set(stats) == set(want)
    for name, b in stats.items():
        np.testing.assert_allclose(b, want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# run_k against sequential steps
# ---------------------------------------------------------------------------

def test_run_k_at_a_constant_lr_is_bit_exact_against_sequential_calls():
    xs, ys = batches(4)
    s1 = dense_step()
    seq = torch.stack([s1(x, y) for x, y in zip(xs, ys)])
    s2 = dense_step()
    got = s2.run_k(xs, ys)
    assert torch.equal(got, seq)
    assert s2.optimizer.num_update == 4
    for (n, a), b in zip(s1.net.named_parameters(), s2.net.parameters()):
        assert torch.equal(a, b), n


def _cosine():
    return optimizer.create("sgd", learning_rate=0.3,
                            lr_scheduler=lr_scheduler.CosineScheduler(
                                max_update=12, base_lr=0.3, final_lr=0.01,
                                warmup_steps=2, warmup_begin_lr=0.05))


class _Custom(lr_scheduler.LRScheduler):
    """A schedule with no closed form."""

    def __call__(self, num_update):
        return self.base_lr / (1 + num_update)


@pytest.mark.parametrize("in_program", [True, False])
def test_run_k_under_a_decaying_schedule_matches_sequential_calls(
        in_program):
    def mk():
        if in_program:
            return _cosine()
        return optimizer.create("sgd", learning_rate=0.3,
                                lr_scheduler=_Custom())
    xs, ys = batches(8)
    s1 = FusedTrainStep(_nets(3)[1], TL, mk())
    seq = torch.stack([s1(x, y) for x, y in zip(xs, ys)])
    s2 = FusedTrainStep(_nets(3)[1], TL, mk(), schedule_in_program=True)
    got = s2.run_k(xs, ys)
    assert (s2._lr_program is not None) == in_program
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = [mk().lr_scheduler(t) for t in range(1, 9)] if not in_program \
        else [_cosine().lr_scheduler(t) for t in range(1, 9)]
    np.testing.assert_allclose(s2.last_lrs.numpy(), want, rtol=1e-6)


def test_run_k_mixed_with_single_steps_matches_a_sequential_run():
    xs, ys = batches(9)
    s1 = FusedTrainStep(_nets(3)[1], TL, _cosine())
    seq = torch.stack([s1(x, y) for x, y in zip(xs, ys)])
    s2 = FusedTrainStep(_nets(3)[1], TL, _cosine(), schedule_in_program=True)
    got = torch.cat([s2(xs[0], ys[0]).reshape(1), s2.run_k(xs[1:5], ys[1:5]),
                     s2(xs[5], ys[5]).reshape(1), s2.run_k(xs[6:], ys[6:])])
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert s2.optimizer.num_update == 9 == s2._t.item()
    np.testing.assert_allclose(
        s2.last_lrs.numpy(), [_cosine().lr_scheduler(t) for t in (7, 8, 9)],
        rtol=1e-6)


def test_ensure_built_spends_no_update():
    xs, ys = batches(2)
    step = dense_step()
    before = weights(step.net)
    assert step.ensure_built(xs[0], ys[0]) is step
    assert step.optimizer.num_update == 0 and step._t.item() == 0
    after = weights(step.net)
    assert all(torch.equal(before[n], after[n]) for n in before)
    ref = dense_step()
    np.testing.assert_array_equal(step(xs[0], ys[0]).numpy(),
                                  ref(xs[0], ys[0]).numpy())


def test_a_trainer_gives_its_optimizer_and_a_name_makes_one():
    _, net = _nets(3)
    tr = gluon.Trainer(net, "adam", {"learning_rate": 0.01}, loop_chunk=6)
    assert FusedTrainStep(net, TL, tr).optimizer is tr.optimizer
    step = FusedTrainStep(net, TL, "nag")
    assert type(step.optimizer) is optimizer.NAG
    profiler.reset_counters()
    step(*(a[0] for a in batches(1)))
    assert profiler.counters()["mxtpu/trainer.dispatches_per_step"] == 1
    profiler.reset_counters()


@pytest.mark.parametrize("cls,kw", [
    (FusedTrainStep, {"remat": True}), (FusedTrainStep, {"mesh": object()}),
    (FusedTrainStep, {"sharding": "fsdp"}),
    (TrainLoop, {"remat": True, "remat_policy": "dots"}),
    (TrainLoop, {"sharding": "dp"}), (TrainLoop, {"prefetch_depth": 3})])
def test_unported_arguments_raise_and_name_their_item(cls, kw):
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*A\.(8|10)"):
        cls(_nets(3)[1], TL, "sgd", **kw)


# ---------------------------------------------------------------------------
# TrainLoop
# ---------------------------------------------------------------------------

def _pairs(n, seed=3):
    xs, ys = batches(n, seed)
    return list(zip(xs, ys))


def test_run_chunk_is_bit_exact_against_sequential_fused_calls():
    xs, ys = batches(4)
    s1 = FusedTrainStep(_nets(3)[1], TL, optimizer.create(
        "sgd", learning_rate=0.1))
    seq = torch.stack([s1(x, y) for x, y in zip(xs, ys)])
    loop = TrainLoop(_nets(3)[1], TL, optimizer.create(
        "sgd", learning_rate=0.1), chunk=4)
    assert torch.equal(loop.run_chunk(xs, ys), seq)


def test_in_program_lr_matches_sequential_and_is_reported():
    xs, ys = batches(8)
    s1 = FusedTrainStep(_nets(3)[1], TL, _cosine())
    seq = torch.stack([s1(x, y) for x, y in zip(xs, ys)])
    loop = TrainLoop(_nets(3)[1], TL, _cosine(), chunk=8)
    profiler.reset_counters()
    got = loop.run_chunk(xs, ys)
    assert loop.in_program_lr
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-6)
    c = profiler.counters()
    assert c["trainloop/trainloop.in_program_lr"] == 1
    assert c["trainloop/trainloop.k"] == 8
    assert c["trainloop/trainloop.chunk_ms"] > 0
    profiler.reset_counters()


def test_chunk_resolution():
    _, net = _nets(3)
    tr = gluon.Trainer(net, "sgd", {"learning_rate": 0.1}, loop_chunk=6)
    assert TrainLoop(net, TL, tr).chunk == 6
    assert TrainLoop(net, TL, tr, chunk=3).chunk == 3
    assert TrainLoop(net, TL, optimizer.create("sgd")).chunk == 4
    with pytest.raises(ValueError, match=">= 1"):
        TrainLoop(net, TL, "sgd", chunk=-1)


def test_fit_trains_and_counts():
    profiler.reset_counters()
    loop = TrainLoop(_nets(3)[1], TL, optimizer.create(
        "sgd", learning_rate=0.5), chunk=4)
    losses = loop.fit(_pairs(4) * 10, steps=40)
    assert isinstance(losses, np.ndarray) and losses.shape == (40,)
    assert losses[-4:].mean() < losses[:4].mean()
    assert loop.num_update == 40 == loop.optimizer.num_update
    c = profiler.counters()
    assert c["trainloop/trainloop.steps"] == 40
    assert c["trainloop/trainloop.chunks"] == 10
    assert c["mxtpu/trainer.dispatches_per_step"] == 0.25
    profiler.reset_counters()


def test_fit_steps_cycle_a_list_and_skip_batches():
    """A list is iterated again when it ends; skip_batches drops the first
    batches (folding whole epochs of a cycled source)."""
    pairs = _pairs(6)
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=2)
    got = loop.fit(pairs, steps=8, skip_batches=13)
    order = [pairs[(13 + i) % 6] for i in range(8)]
    ref = TrainLoop(_nets(3)[1], TL, "sgd", chunk=2)
    want = ref.fit(order, steps=8, cycle=False)
    np.testing.assert_array_equal(got, want)


def test_fit_epochs_drops_partial_chunk():
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=4)
    assert loop.fit(_pairs(10), epochs=1).shape == (8,)


class _Rewindable:
    """A source with reset(): four batches an epoch."""

    def __init__(self):
        self._pairs, self.resets, self._it = _pairs(4), 0, None

    def reset(self):
        self.resets += 1
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._pairs)
        return next(self._it)


def test_fit_epochs_resets_the_source_each_epoch():
    src = _Rewindable()
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=4)
    assert loop.fit(src, epochs=3).shape == (12,)
    assert src.resets == 3


def test_fit_steps_exhausted_source_raises_clearly():
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=4)
    with pytest.raises(ValueError, match="exhausted after 8 of 16"):
        loop.fit((b for b in _pairs(8)), steps=16)


def test_fit_epochs_oneshot_iterator_raises():
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=4)
    with pytest.raises(ValueError, match="epoch 2 produced no"):
        loop.fit((b for b in _pairs(8)), epochs=2)


def test_fit_labelless_source_rejected():
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=2)
    with pytest.raises(ValueError, match="labeled batches"):
        loop.fit([np.zeros((4, 8), np.float32) for _ in range(4)], steps=2)


def test_fit_steps_smaller_than_chunk_rejected():
    loop = TrainLoop(_nets(3)[1], TL, "sgd", chunk=8)
    with pytest.raises(ValueError, match="less than one chunk"):
        loop.fit(_pairs(4), steps=4)
    with pytest.raises(ValueError, match="exactly one of"):
        loop.fit(_pairs(4), steps=8, epochs=1)
    with pytest.raises(NotImplementedError, match=r"A\.11"):
        loop.fit(_pairs(8), steps=8, resilience="ckpt")


def test_a_change_of_weight_decay_reaches_the_next_step():
    """wd is a number in the step (a graph a value on a card): after
    ``optimizer.wd`` changes, the next step uses it, as the JAX step reads
    wd at every call."""
    xs, ys = batches(3)
    steps = []
    for wd_after in (0.0, 0.5):
        step = dense_step()
        step(xs[0], ys[0])
        step.optimizer.wd = wd_after
        steps.append((step, [step(x, y) for x, y in zip(xs[1:], ys[1:])]))
    (zero, l0), (half, l5) = steps
    assert torch.equal(l0[0], l5[0])    # the change shows from the update
    assert not torch.equal(l0[1], l5[1])
    w0 = dict(zero.net.named_parameters())
    assert all(not torch.equal(p, w0[n])
               for n, p in half.net.named_parameters())
