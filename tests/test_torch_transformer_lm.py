"""The port's TransformerLM against the JAX package's, with the same weights.

A small JAX TransformerLM (2 layers, 128 units, 2 heads of 64, vocab 97)
gets random weights from numpy; they are carried into the port with
``convert.load_jax_params``. On the JAX side the Pallas kernels are selected
(``MXTPU_PALLAS=force``, interpret mode on the CPU); on the port's side the
CPU tensors take the kernels' plain versions, forward and backward.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu_torch import autograd, cpu, gluon
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import (TransformerLM, lm_loss,
                                              transformer_lm_base)
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln

VOCAB = 97
CFG = dict(num_layers=2, units=128, hidden_size=256, num_heads=2,
           max_length=32)
# f32 on both sides, sums in other orders through 2 layers
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_params(net, seed, spread=0.1):
    """Random weights with real spread (not the near-uniform Normal(0.02)),
    as numpy arrays by structural name."""
    net.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        a = (spread * rng.randn(*p.shape)).astype(np.float32)
        if name.endswith("gamma"):
            a = a + 1.0
        p.set_data(nd.array(a))
        arrays[name] = a
    return arrays


def pair(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jnet = JaxLM(VOCAB, **cfg)
    arrays = jax_params(jnet, seed)
    return jnet, load_jax_params(TransformerLM(VOCAB, **cfg), arrays)


def tokens(seed, shape=(3, 24)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(
        np.int32)


def test_lm_logits_loss_grads_and_step_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet = pair(seed=0)
    x = tokens(1)
    xj, xt = nd.array(x, dtype="int32"), torch.from_numpy(x)
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 1e-3})
    ttrainer = gluon.Trainer(tnet, "adam", {"learning_rate": 1e-3})

    with jautograd.record():
        jlogits = jnet(xj)
        jloss = jax_lm_loss(jlogits, xj)
    jloss.backward()
    fa.reset_counts()
    ln.reset_counts()
    with autograd.record():
        tlogits = tnet(xt)
        tloss = lm_loss(tlogits, xt)
    autograd.backward(tloss)
    # the kernels' route on the CPU, forward and backward: 2 attentions,
    # 2 * 2 + 1 layer norms
    assert fa.plain_calls == 2
    assert (fa.dq_plain_calls, fa.dkv_plain_calls) == (2, 2)
    assert (ln.launches, ln.plain_calls) == (0, 5)

    assert tlogits.shape == (3, 24, VOCAB) and tloss.shape == (3 * 23,)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits.asnumpy(),
                               **TOL)
    np.testing.assert_allclose(tloss.detach().numpy(), jloss.asnumpy(),
                               **TOL)
    jp = jnet._collect_params_with_prefix()
    tp = dict(tnet.named_parameters())
    assert sorted(tp) == sorted(jp)
    jgrads = {}
    for name, p in tp.items():
        g = jgrads[name] = jp[name].grad().asnumpy()
        # gradients of the summed loss; relative to each one's scale
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(g).max()),
                                   err_msg=name)

    jtrainer.step(3)
    ttrainer.step(3)
    for name, p in tp.items():
        assert p.grad is None, name
        w, wj = p.detach().numpy(), jp[name].data().asnumpy()
        # Adam's first step is lr * g / (|g| + eps) per element, so where a
        # gradient is roundoff (the key bias's is 0 in exact arithmetic:
        # softmax ignores a shift of a row) either side may step by +-lr.
        # Everywhere the steps differ by at most 2 lr; where the gradient is
        # above 1e-4 of its parameter's largest, by f32 rounding.
        np.testing.assert_array_less(np.abs(w - wj), 2.01e-3, err_msg=name)
        g = jgrads[name]
        real = np.abs(g) > 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(w[real], wj[real], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_greedy_generate_matches_jax_token_for_token(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet = pair(seed=2)
    prompt = tokens(3, (2, 6))
    ref = jnet.generate(nd.array(prompt, dtype="int32"), 8).asnumpy()
    fa.reset_counts()
    out = tnet.generate(torch.from_numpy(prompt), 8)
    assert fa.plain_calls == 2          # the prefill's flash, one per layer
    assert out.dtype == torch.int32 and out.shape == (2, 14)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int32))
    np.testing.assert_array_equal(out[:, :6].numpy(), prompt)


def test_param_names_are_the_jax_names_and_the_tied_head_adds_none():
    for tie in (True, False):
        jnet = JaxLM(VOCAB, tie_weights=tie, **CFG)
        jnet.initialize()
        names = set(dict(TransformerLM(VOCAB, tie_weights=tie,
                                       **CFG).named_parameters()))
        assert names == set(jnet._collect_params_with_prefix())
        assert ("head.weight" in names) == (not tie)
        assert "layer1.attention.qkv.weight" in names


def _port_lm(seed=0, **kw):
    cfg = dict(CFG, **kw)
    return transformer_lm_base(VOCAB, ctx=cpu(), seed=seed, sigma=0.2, **cfg)


def test_step_decode_matches_full_forward_and_causality():
    net = _port_lm(seed=4)
    prompt = torch.from_numpy(tokens(5, (2, 7)))
    with torch.no_grad():
        full = net(prompt)
        caches = net.init_cache(2)
        for t in range(7):
            lg, caches = net._step_with_cache(prompt[:, t:t + 1], t, caches)
            # the plain masked decode against the flash prefill: 1e-4
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), **TOL)
        changed = prompt.clone()
        changed[:, -1] = (changed[:, -1] + 1) % VOCAB
        other = net(changed)
    np.testing.assert_array_equal(other[:, :-1].numpy(), full[:, :-1].numpy())
    assert (other[:, -1] - full[:, -1]).abs().max() > 1e-4


def test_generate_equals_recompute_and_sampling_is_seeded():
    net = _port_lm(seed=6)
    prompt = torch.from_numpy(tokens(7, (2, 4)))
    out = net.generate(prompt, 5)
    seq = prompt
    with torch.no_grad():
        for _ in range(5):
            nxt = net(seq)[:, -1].argmax(-1).to(seq.dtype)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())
    a = net.generate(prompt, 3, temperature=1.0, seed=7)
    b = net.generate(prompt, 3, temperature=1.0, seed=7)
    assert a.shape == (2, 7)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="max_length"):
        net.generate(torch.zeros((1, 30), dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="max_length"):
        net(torch.zeros((1, 40), dtype=torch.int64))


def test_lm_trains_on_repeating_pattern():
    """A cyclic sequence is perfectly predictable: the loss must collapse
    and greedy generation must continue the cycle (the JAX package's
    test_lm_trains_on_repeating_pattern, on the port)."""
    vocab, period = 12, 4
    net = transformer_lm_base(vocab, ctx=cpu(), seed=0, num_layers=2,
                              units=64, hidden_size=128, num_heads=4,
                              max_length=24)
    trainer = gluon.Trainer(net, "adam", {"learning_rate": 3e-3})
    seq = np.tile(np.arange(period), 5)[None, :20].astype(np.int64)
    x = torch.from_numpy(np.repeat(seq, 4, axis=0))
    first = last = None
    for _ in range(150):
        with autograd.record():
            loss = lm_loss(net(x), x)
        autograd.backward(loss)
        trainer.step(4)
        last = float(loss.detach().mean())
        first = last if first is None else first
    assert last < first * 0.2, (first, last)
    out = net.generate(torch.from_numpy(seq[:, :6]), period)[0, 6:]
    np.testing.assert_array_equal(out.numpy(),
                                  [(6 + i) % period for i in range(period)])


def test_transformer_lm_base_needs_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="ctx=cpu"):
        transformer_lm_base()
    net = transformer_lm_base(vocab_size=50, ctx=cpu(), max_length=16)
    assert len(net.layers) == 12
    assert net.layer11.attention.qkv.weight.shape == (2304, 768)
    assert net.layer0.ffn.ffn_1.weight.shape == (3072, 768)
    assert not hasattr(net, "head")
    assert next(net.parameters()).device.type == "cpu"
