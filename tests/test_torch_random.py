"""The port's seeded random streams: ``random.seed``/``generator``, dropout
(``axes``, ``mode="always"``, the device's generator by default), SGLD's
noise, and the fused step's fresh masks a step.

Every draw of the port comes from a ``torch.Generator`` of
``random.generator(device)``; none touches torch's global RNG. SGLD's
standardised noise is held to N(0, 1) within 4 sigma, beside the JAX
package's SGLD on the same inputs.
"""
import random as pyrandom

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import (autograd, cpu, gluon, models, ops,
                                       optimizer, random)
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.parallel import FusedTrainStep


def dropout_mask(x, **kw):
    """Where Dropout kept `x` (ones), in training mode."""
    with autograd.record():
        return tnn.Dropout(0.5, **kw)(x) != 0


def test_the_same_seed_gives_the_same_mask():
    x = torch.ones(64, 64)
    random.seed(11)
    a = dropout_mask(x)
    b = dropout_mask(x)
    random.seed(11)
    assert torch.equal(dropout_mask(x), a)
    assert torch.equal(dropout_mask(x), b)
    assert not torch.equal(a, b)
    random.seed(12)
    assert not torch.equal(dropout_mask(x), a)


def test_seed_seeds_python_numpy_and_one_device():
    random.seed(5)
    want = (pyrandom.random(), np.random.rand())
    random.seed(5)
    assert (pyrandom.random(), np.random.rand()) == want
    g = random.generator(cpu())
    assert g is random.generator("cpu") is random.generator(
        torch.device("cpu"))
    random.seed(9, ctx=cpu())
    first = torch.rand(4, generator=g)
    random.seed(9)
    assert torch.equal(torch.rand(4, generator=g), first)


@pytest.mark.parametrize("axes", [(1,), (0, 2)])
def test_axes_share_one_mask(axes):
    random.seed(0)
    keep = dropout_mask(torch.ones(8, 6, 10), axes=axes)
    for a in axes:
        assert torch.equal(keep, keep.narrow(a, 0, 1).expand_as(keep))
    assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_scale(rate):
    random.seed(1)
    n = 100_000
    x = torch.full((n,), 3.0)
    with autograd.record():
        y = ops.dropout(x, rate, autograd.is_training())
    keep = 1.0 - rate
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - keep) <= 4 * np.sqrt(keep * rate / n)
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 3.0) / keep)


def test_mode_always_applies_outside_record():
    x = torch.ones(1000)
    random.seed(2)
    assert torch.equal(tnn.Dropout(0.5)(x), x)
    with autograd.record(train_mode=False):
        assert torch.equal(tnn.Dropout(0.5)(x), x)
    always = tnn.Dropout(0.5, mode="always")(x)
    assert 0 < int((always == 0).sum()) < 1000
    assert 0 < int((ops.Dropout(x, 0.5, mode="always") == 0).sum()) < 1000


def test_an_explicit_generator_is_used_instead():
    x = torch.ones(256)
    g = torch.Generator().manual_seed(3)
    with autograd.record():
        a = tnn.Dropout(0.5, generator=g)(x)
        g.manual_seed(3)
        random.seed(4)
        b = tnn.Dropout(0.5, generator=g)(x)
    assert torch.equal(a, b)


def small_pretrainer(dropout=0.1):
    bert = models.BERTModel(num_layers=1, units=32, hidden_size=64,
                            num_heads=4, max_length=16, vocab_size=50,
                            dropout=dropout)
    tnn.init_params(bert, seed=0)
    return models.BERTForPretrain(bert, 50)


def pretrain_batch():
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randint(0, 50, (2, 16))),
            torch.zeros(2, 16, dtype=torch.int64), torch.tensor([16, 11]),
            torch.tensor([[1, 4, 7], [0, 2, 9]]),
            torch.from_numpy(rng.randint(0, 50, (2, 3))),
            torch.tensor([0, 1]))


def test_training_never_touches_the_global_rng():
    net = small_pretrainer()
    ids, tt, vl, pos, lab, nsp = pretrain_batch()
    before = torch.random.get_rng_state()
    for rule in ("adamw", "sgld"):
        trainer = gluon.Trainer(net, rule, {"learning_rate": 1e-3})
        with autograd.record():
            mlm, ns = net(ids, tt, vl, pos)
            loss = models.BERTPretrainLoss()(mlm, ns, lab, nsp)
        autograd.backward(loss)
        trainer.step(2)
    assert torch.equal(torch.random.get_rng_state(), before)


def sgld_noise(w, g, lr, wd, rescale):
    """What one SGLD step added beyond its deterministic part, over
    sqrt(lr): N(0, 1) draws."""
    want = w - lr / 2 * (g * rescale + wd * w)
    return lambda new: (new - want) / np.sqrt(lr)


def check_standard_normal(z):
    n = z.size
    assert abs(z.mean()) <= 4 / np.sqrt(n), z.mean()
    assert abs(z.std() - 1) <= 4 / np.sqrt(2 * n), z.std()


def test_sgld_noise_is_standard_normal_as_in_jax():
    from incubator_mxnet_tpu import nd
    from incubator_mxnet_tpu import optimizer as joptimizer
    rng = np.random.RandomState(6)
    w = rng.randn(100_000).astype(np.float32)
    g = rng.randn(100_000).astype(np.float32)
    lr, wd, rescale = 1e-2, 0.1, 0.5
    noise = sgld_noise(w.astype(np.float64), g.astype(np.float64), lr, wd,
                       rescale)
    random.seed(0)
    opt = optimizer.create("sgld", learning_rate=lr, wd=wd,
                           rescale_grad=rescale)
    tw = torch.from_numpy(w.copy())
    opt.update(0, tw, torch.from_numpy(g), ())
    check_standard_normal(noise(tw.numpy().astype(np.float64)))
    jopt = joptimizer.create("sgld", learning_rate=lr, wd=wd,
                             rescale_grad=rescale)
    jw = nd.array(w)
    jopt.update(0, jw, nd.array(g), ())
    check_standard_normal(noise(jw.asnumpy().astype(np.float64)))
    # a second step draws anew
    again = torch.from_numpy(w.copy())
    opt.update(0, again, torch.from_numpy(g), ())
    assert not torch.equal(again, tw)


def test_sgld_skip_leaves_the_weight_bit_unchanged():
    opt = optimizer.create("sgld", learning_rate=0.1)
    w = torch.randn(50, generator=torch.Generator().manual_seed(1))
    before = w.clone()
    opt.update_multi([0], [w], [torch.ones(50)], [()],
                     skip=torch.tensor(True))
    assert torch.equal(w, before)
    opt.update_multi([0], [w], [torch.ones(50)], [()],
                     skip=torch.tensor(False))
    assert not torch.equal(w, before)
    assert opt.num_update == 2


def test_fused_step_refuses_sgld_in_both_packages():
    from incubator_mxnet_tpu import gluon as jgluon
    from incubator_mxnet_tpu import nd
    from incubator_mxnet_tpu.parallel import FusedTrainStep as JaxStep
    x, y = np.ones((2, 4), np.float32), np.ones((2, 3), np.float32)
    jnet = jgluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    with pytest.raises(NotImplementedError):
        JaxStep(jnet, jgluon.loss.L2Loss(), "sgld")(nd.array(x), nd.array(y))
    net = tnn.Dense(3, in_units=4)
    step = FusedTrainStep(net, lambda out, t: ((out - t) ** 2).mean(1),
                          "sgld")
    with pytest.raises(NotImplementedError, match="SGLD"):
        step(x, y)
    w = torch.zeros(3)
    with pytest.raises(NotImplementedError):
        optimizer.create("sgld").update_fused([w], [torch.ones(3)], [()],
                                              0.1, 0.0, 1, [1.0], [1.0])


def dropout_net():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(32, activation="relu", in_units=16), tnn.Dropout(0.5),
            tnn.Dense(4, in_units=32))
    tnn.init_params(net, sigma=0.5, seed=0)
    return net


def test_fused_step_draws_fresh_masks_and_follows_the_seed():
    """On the CPU the step runs eagerly from the device's generator: two
    steps at lr 0 (the weights stay) see different masks, and re-seeding
    repeats them."""
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    step = FusedTrainStep(dropout_net(),
                          lambda out, t: ((out - t) ** 2).mean(1),
                          optimizer.create("adam", learning_rate=0.0))
    runs = []
    for _ in range(2):
        random.seed(7)
        runs.append([float(step(x, y)) for _ in range(3)])
    assert len(set(runs[0])) == 3
    assert runs[0] == runs[1]


def test_registering_a_generator_with_a_graph():
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="register_generator_state"):
        ops.cuda.register_generator(object(), g)

    class Graph:
        registered = []

        def register_generator_state(self, gen):
            self.registered.append(gen)

    graph = Graph()
    ops.cuda.register_generator(graph, g)
    assert graph.registered == [g]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_embedding_gradient_sums_each_row_once_in_f32(dtype):
    """The embedding's weight gradient (``ops._raw.embedding``): each
    row's gradients summed in f32 in one fixed order and rounded once to
    the table's dtype, on a two-row table whose rows repeat thousands of
    times (BERT's token types). ``F.embedding``'s CUDA backward sums such
    a row in an order that changes between calls, which cost two runs from
    one seed their bit-for-bit agreement on the card."""
    from incubator_mxnet_tpu_torch.ops import _raw
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 2, (32, 128)))
    grad = torch.from_numpy(rng.randn(32, 128, 16).astype(np.float32))
    w = torch.zeros(2, 16, dtype=dtype, requires_grad=True)
    _raw.embedding(ids, w).backward(grad.to(dtype))
    want = torch.zeros(2, 16, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), grad.to(dtype).double().reshape(-1, 16))
    assert w.grad.dtype == dtype
    # f32: 2048 terms a row summed in f32 against the f64 sum; 16-bit: one
    # rounding of the f32 sum (a bf16 unit is 2**-8 of the value)
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    np.testing.assert_allclose(w.grad.double().numpy(),
                               want.to(dtype).double().numpy(), **tol)
    again = torch.zeros(2, 16, dtype=dtype, requires_grad=True)
    _raw.embedding(ids, again).backward(grad.to(dtype))
    assert torch.equal(again.grad, w.grad)
