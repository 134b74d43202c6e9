"""The port's BERT pretraining (BERTForPretrain + BERTPretrainLoss) against
the JAX package's, with the same weights.

A small JAX BERTForPretrain (2 layers, 64 wide, 4 heads, vocab 100,
dropout 0) gets random weights from numpy, which carry into the port by
name with ``convert.load_jax_params``: the tied ``bert.word_embed.weight``
and ``mlm_bias`` among them. On the JAX side the Pallas kernels are
selected (``MXTPU_PALLAS=force``, interpret mode on the CPU); the port's
CPU tensors take the kernels' plain versions. Scores, loss, every
gradient and three AdamW steps under a CosineScheduler are compared.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu.optimizer import lr_scheduler as jsched
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, models
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
from incubator_mxnet_tpu_torch.optimizer import lr_scheduler as tsched

CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
           max_length=32, vocab_size=100, dropout=0.0, use_pooler=True)
V, B, T, M = 100, 3, 16, 5


def jax_arrays(net, seed):
    """Random weights with real spread (gamma near one, small biases);
    returns them as numpy arrays by structural name."""
    net.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        leaf = name.rsplit(".", 1)[-1]
        a = rng.randn(*p.shape).astype(np.float32)
        a = 1.0 + 0.1 * a if leaf == "gamma" else (
            0.1 * a if leaf == "beta" or leaf.endswith("bias") else 0.3 * a)
        p.set_data(nd.array(a))
        arrays[name] = a
    return arrays


def pair(seed=0):
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=V)
    arrays = jax_arrays(jnet, seed)
    tnet = models.BERTForPretrain(models.BERTModel(**CFG), V)
    return jnet, load_jax_params(tnet, arrays), arrays


def batch(seed, float_positions=False, labels="some_ignored"):
    """ids, token types, valid lengths, masked positions (distinct, inside
    each valid length), MLM labels (-1 where ignored) and NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    tt = rng.randint(0, 2, (B, T)).astype(np.int32)
    vl = np.array([T, 9, 12], np.int32)
    pos = np.stack([rng.choice(int(n), M, replace=False) for n in vl])
    pos = pos.astype(np.float32 if float_positions else np.int32)
    lab = rng.randint(0, V, (B, M)).astype(np.int32)
    if labels == "some_ignored":
        lab[1, 3:] = -1
        lab[2, 0] = -1
    elif labels == "all_ignored":
        lab[:] = -1
    nsp = rng.randint(0, 2, B).astype(np.int32)
    return ids, tt, vl, pos, lab, nsp


def run_jax(net, b, loss_fn=None):
    ids, tt, vl, pos, lab, nsp = b
    loss_fn = loss_fn or jbert.BERTPretrainLoss()
    with jautograd.record():
        mlm, ns = net(nd.array(ids, dtype="int32"), nd.array(tt, dtype="int32"),
                      nd.array(vl, dtype="int32"),
                      nd.array(pos, dtype=str(pos.dtype)))
        loss = loss_fn(mlm, ns, nd.array(lab, dtype="int32"),
                       nd.array(nsp, dtype="int32"))
    loss.backward()
    return mlm.asnumpy(), ns.asnumpy(), float(loss.asnumpy())


def run_torch(net, b, loss_fn=None):
    ids, tt, vl, pos, lab, nsp = (torch.from_numpy(a) for a in b)
    loss_fn = loss_fn or models.BERTPretrainLoss()
    with autograd.record():
        mlm, ns = net(ids, tt, vl, pos)
        loss = loss_fn(mlm, ns, lab, nsp)
    autograd.backward(loss)
    return mlm.detach().numpy(), ns.detach().numpy(), float(loss.detach())


def test_names_load_one_to_one_with_the_tied_decoder():
    jnet, tnet, arrays = pair()
    names = [n for n, _ in tnet.named_parameters()]
    assert names == list(jnet._collect_params_with_prefix())
    assert names[0] == "mlm_bias" and "bert.word_embed.weight" in names
    # the decoder reads the embedding itself: one parameter, not a copy
    assert sum(p is tnet.bert.word_embed.weight
               for p in tnet.parameters()) == 1
    np.testing.assert_array_equal(tnet.mlm_bias.detach().numpy(),
                                  arrays["mlm_bias"])


@pytest.mark.parametrize("case", [
    dict(float_positions=False, labels="some_ignored"),
    dict(float_positions=True, labels="some_ignored"),
    dict(float_positions=True, labels="none_ignored"),
    dict(float_positions=False, labels="all_ignored")],
    ids=["int_pos", "float_pos", "no_ignored", "all_ignored"])
def test_scores_loss_and_gradients_match_jax(monkeypatch, case):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = pair(seed=1)
    b = batch(2, **case)
    mlm_j, nsp_j, loss_j = run_jax(jnet, b)
    ln.reset_counts()
    mlm_t, nsp_t, loss_t = run_torch(tnet, b)
    # the embedding LN, 2 x 2 in the cells and mlm_ln, on their plain path
    assert (ln.launches, ln.plain_calls) == (0, 6)
    assert mlm_t.shape == (B, M, V) and nsp_t.shape == (B, 2)
    # f32 on both sides, sums in other orders through two layers: scores
    # within 1e-5 of the largest score, the loss within 1e-5
    for got, want in ((mlm_t, mlm_j), (nsp_t, nsp_j)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
    if case["labels"] == "all_ignored":
        # the MLM term is 0 / max(0, 1): the loss is the NSP term alone
        logp = torch.log_softmax(torch.from_numpy(nsp_t), -1)
        want = -logp[torch.arange(B), torch.from_numpy(b[5]).long()].mean()
        assert abs(loss_t - float(want)) < 1e-6
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        gj = jp[name].grad().asnumpy()
        scale = max(float(np.abs(gj).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - gj).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    # the tied weight's gradient sums the embedding's and the decoder's
    assert float(tnet.bert.word_embed.weight.grad.abs().sum()) > 0


def test_three_adamw_cosine_steps_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = pair(seed=4)
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = jgluon.Trainer(jnet.collect_params(), "adamw", dict(
        opt, lr_scheduler=jsched.CosineScheduler(3, base_lr=1e-3,
                                                 warmup_steps=1)))
    ttr = gluon.Trainer(tnet, "adamw", dict(
        opt, lr_scheduler=tsched.CosineScheduler(3, base_lr=1e-3,
                                                 warmup_steps=1)))
    jp = jnet._collect_params_with_prefix()
    units = CFG["units"]
    lr_sum = 0.0
    for step in range(3):
        b = batch(10 + step)
        _, _, loss_j = run_jax(jnet, b)
        jtr.step(B)
        _, _, loss_t = run_torch(tnet, b)
        ttr.step(B)
        lr_sum += ttr.learning_rate
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-5)
        for name, p in tnet.named_parameters():
            w, wj = p.detach().numpy(), jp[name].data().asnumpy()
            # Adam steps +-lr per element where a gradient is roundoff:
            # the key bias's (qkv.bias[units:2 units]) is 0 in exact
            # arithmetic, softmax ignores a shift of a row. Everywhere the
            # two differ by at most 2 lr a step; off the key bias, by f32
            # rounding
            np.testing.assert_array_less(np.abs(w - wj), 2 * lr_sum + 1e-6,
                                         err_msg=f"step {step} {name}")
            if name.endswith("qkv.bias"):
                w, wj = (np.delete(a, np.s_[units:2 * units]) for a in (w, wj))
            np.testing.assert_allclose(w, wj, rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {name}")
    assert ttr.optimizer.num_update == 3 == jtr.optimizer.num_update


def test_mlm_bias_starts_at_zero_as_in_jax():
    tnet = models.BERTForPretrain(models.BERTModel(**CFG), V)
    assert float(tnet.mlm_bias.detach().abs().max()) == 0.0
    assert float(tnet.mlm_transform.weight.detach().std()) > 0.01
    tnn.init_params(tnet, seed=5)
    assert float(tnet.mlm_bias.detach().abs().max()) == 0.0
    assert float(tnet.mlm_transform.bias.detach().abs().max()) == 0.0
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=V)
    jnet.initialize(init=mx.init.Normal(0.02))
    assert float(np.abs(jnet.mlm_bias.data().asnumpy()).max()) == 0.0


def test_no_pooler_raises_in_both_packages():
    cfg = dict(CFG, use_pooler=False)
    with pytest.raises(ValueError, match="use_pooler=True"):
        jbert.BERTForPretrain(jbert.BERTModel(**cfg), vocab_size=V)
    with pytest.raises(ValueError, match="use_pooler=True"):
        models.BERTForPretrain(models.BERTModel(**cfg), V)


def test_heads_follow_bert_onto_its_device_and_dtype():
    bert = models.get_bert_model("bert_12_768_12", vocab_size=50,
                                 max_length=16, ctx=cpu()).to(torch.bfloat16)
    net = models.BERTForPretrain(bert, 50)
    assert {(p.device.type, p.dtype) for p in net.parameters()} == {
        ("cpu", torch.bfloat16)}


def test_pretraining_loss_falls_on_one_batch():
    """The example's recipe at toy size (dropout 0.1, AdamW, cosine
    schedule): 30 steps on one batch halve the loss."""
    from incubator_mxnet_tpu_torch import random
    random.seed(0)
    bert = models.BERTModel(**dict(CFG, dropout=0.1))
    tnn.init_params(bert, seed=0)
    net = models.BERTForPretrain(bert, V)
    trainer = gluon.Trainer(net, "adamw", {
        "learning_rate": 1e-2, "wd": 0.01,
        "lr_scheduler": tsched.CosineScheduler(30, base_lr=1e-2,
                                               warmup_steps=3)})
    b = batch(20, labels="none_ignored")
    losses = []
    for _ in range(30):
        losses.append(run_torch(net, b)[2])
        trainer.step(B)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses
