"""bf16 through the port against the JAX package, on small models.

Both sides get the same numpy weights and are cast to bf16: the JAX
package by ``Block.cast("bfloat16")``, the port by ``module.to(
torch.bfloat16)``, which casts the same tensors (every floating parameter
and buffer, BatchNorm's moving statistics among them: checked name by
name). The JAX side runs its Pallas kernels in interpret mode
(``MXTPU_PALLAS=force``); the port's CPU tensors take the kernels' plain
versions. Covered: a 2-layer BERT, a 2-layer TransformerLM (forward, the
loss's dtype, one training step's loss and gradients) and the
BatchNormReLU ResNet (predict forward, one training step's loss, gradients
and moving statistics), then ``FrozenModel(compute_dtype="bfloat16")``:
ResNet against the JAX FrozenModel, BERT against the JAX BERT after
``cast`` (the JAX FrozenModel casts token ids to bf16 and answers in the
request's int32: faults the port does not copy, checked here).

Tolerance. bf16 keeps 8 significant bits, so where the two sides round a
value differently (other summation orders, an FMA against a multiply and
an add) the difference is 2**-8 of it, and every later layer carries it
on. Through BatchNorm's backward the batch statistics cancel most of the
gradient: in these nets either side's bf16 gradients are 10-100% off the
f32 ones (Frobenius norm), while the two sides stay within a few percent
of each other. So each compared tensor is held two ways against the port's
f32 result from the same weights (``truth``; the port's f32 paths are held
to the JAX package's at 1e-4 in the other tests): the port's bf16 result
is no further from it than 1.5 times the JAX package's bf16 result plus
5e-3 (relative norms), and the two bf16 results are within 0.25 of the
JAX one's norm of each other.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu.serving import FrozenModel as JaxFrozenModel
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, ops
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_loss
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
from incubator_mxnet_tpu_torch.serving import FrozenModel

from test_torch_resnet import (CLASSES, LAYERS, bnrelu_pair, images,
                               jax_moving_stats)

BF16 = torch.bfloat16
WORSE, SLACK, APART = 1.5, 5e-3, 0.25


def rel(a, b):
    """Relative distance ||a - b|| / ||b|| (Frobenius)."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(what, got, want, truth):
    """The port's bf16 `got` against the JAX package's bf16 `want`, both
    against the f32 `truth` (see the module's notes)."""
    got, want, truth = (np.asarray(a, np.float32) for a in (got, want,
                                                            truth))
    assert got.shape == want.shape == truth.shape, what
    assert np.isfinite(got).all(), what
    e_port, e_jax = rel(got, truth), rel(want, truth)
    assert e_port <= WORSE * e_jax + SLACK, (what, e_port, e_jax)
    assert rel(got, want) <= APART, (what, rel(got, want))


def f32(a):
    """An NDArray or a tensor as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a._data.astype("float32"))


def jax_random(net, seed, spread):
    """Random weights with spread, gamma near one, as numpy by name."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        a = (spread * rng.randn(*p.shape)).astype(np.float32)
        if name.endswith("gamma"):
            a = a + 1.0
        p.set_data(nd.array(a))
        arrays[name] = a
    return arrays


def cast_names(jnet, tnet):
    """({name: dtype} of the JAX net after cast, the same of the port's
    module after .to) over parameters and buffers."""
    jnet.cast("bfloat16")
    tnet.to(BF16)
    jd = {n: str(p.data()._data.dtype)
          for n, p in jnet._collect_params_with_prefix().items()}
    td = {n: str(t.dtype).split(".")[-1]
          for n, t in list(tnet.named_parameters())
          + list(tnet.named_buffers())}
    return jd, td


# ---------------------------------------------------------------------------
# Block.cast <-> Module.to
# ---------------------------------------------------------------------------

def test_module_to_casts_what_block_cast_casts():
    jnet, tnet, _ = bnrelu_pair(seed=1)
    jd, td = cast_names(jnet, tnet)
    assert jd == td and set(jd.values()) == {"bfloat16"}
    assert "features.0.bn.running_var" in td
    bert_cfg = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
                    max_length=16, vocab_size=50, dropout=0.0)
    jb = JaxBERT(**bert_cfg)
    jb.initialize()
    jd, td = cast_names(jb, load_jax_params(
        BERTModel(**bert_cfg), jax_random(jb, 0, 0.1)))
    assert jd == td and set(jd.values()) == {"bfloat16"}


def test_loss_keeps_the_logits_dtype():
    from incubator_mxnet_tpu.ops import _raw as jraw
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 11).astype(np.float32)
    labels = rng.randint(0, 11, 5).astype(np.int32)
    want = jraw.softmax_cross_entropy(
        nd.array(logits).astype("bfloat16")._data, nd.array(labels)._data)
    got = ops.softmax_cross_entropy(torch.from_numpy(logits).to(BF16),
                                    torch.from_numpy(labels))
    truth = ops.softmax_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    assert str(want.dtype) == "bfloat16" and got.dtype == BF16
    assert truth.dtype == torch.float32     # f32 logits, an f32 loss
    close("bf16 loss", f32(got), np.asarray(want.astype("float32")),
          f32(truth))


# ---------------------------------------------------------------------------
# BERT and the LM
# ---------------------------------------------------------------------------

BERT = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
            max_length=32, vocab_size=300, dropout=0.0)


def bert_pair(seed=0):
    jnet = JaxBERT(**BERT)
    jnet.initialize(init=mx.init.Normal(0.02))
    arrays = jax_random(jnet, seed, 0.3)
    tnet = load_jax_params(BERTModel(**BERT), arrays).eval()
    return jnet, tnet


def bert_ids(seed=1, n=3):
    return np.random.RandomState(seed).randint(0, 300, (n, 16)).astype(
        np.int32)


def torch_forward(net, x):
    with torch.inference_mode():
        out = net(torch.from_numpy(x))
    return [f32(o) for o in (out if isinstance(out, tuple) else (out,))]


def test_bert_bf16_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet = bert_pair()
    ids = bert_ids()
    truth = torch_forward(tnet, ids)
    jnet.cast("bfloat16")
    tnet.to(BF16)
    seq_j, pooled_j = jnet(nd.array(ids, dtype="int32"))
    fa.reset_counts()
    ln.reset_counts()
    with torch.inference_mode():
        seq_t, pooled_t = tnet(torch.from_numpy(ids))
    assert (fa.plain_calls, ln.plain_calls) == (2, 5)
    assert seq_t.dtype == pooled_t.dtype == BF16
    assert str(seq_j._data.dtype) == "bfloat16"
    close("sequence output", f32(seq_t), f32(seq_j), truth[0])
    close("pooled output", f32(pooled_t), f32(pooled_j), truth[1])


LM = dict(num_layers=2, units=128, hidden_size=256, num_heads=2,
          max_length=32)


def lm_step(net, x):
    """Logits, per-token loss and every gradient of one port step."""
    with autograd.record():
        logits = net(x)
        loss = lm_loss(logits, x)
    autograd.backward(loss)
    grads = {n: p.grad for n, p in net.named_parameters()}
    return logits, loss, grads


def test_lm_bf16_loss_and_gradients_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet = JaxLM(97, **LM)
    jnet.initialize(init=mx.init.Normal(0.02))
    arrays = jax_random(jnet, 0, 0.1)
    tnet = load_jax_params(TransformerLM(97, **LM), arrays)
    x = np.random.RandomState(1).randint(0, 97, (3, 24)).astype(np.int32)
    xj, xt = nd.array(x, dtype="int32"), torch.from_numpy(x)
    t_logits, t_loss, t_grads = lm_step(copy.deepcopy(tnet), xt)
    jnet.cast("bfloat16")
    tnet.to(BF16)
    with jautograd.record():
        jlogits = jnet(xj)
        jloss = jax_lm_loss(jlogits, xj)
    jloss.backward()
    fa.reset_counts()
    tlogits, tloss, tgrads = lm_step(tnet, xt)
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == \
        (2, 2, 2)
    # the loss keeps the logits' dtype on both sides
    assert tlogits.dtype == tloss.dtype == BF16
    assert str(jloss._data.dtype) == "bfloat16"
    close("logits", f32(tlogits), f32(jlogits), f32(t_logits))
    close("per-token loss", f32(tloss), f32(jloss), f32(t_loss))
    jp = jnet._collect_params_with_prefix()
    for name, g in tgrads.items():
        assert g.dtype == BF16, name
        close(name, f32(g), f32(jp[name].grad()), f32(t_grads[name]))


# ---------------------------------------------------------------------------
# ResNet (BatchNormReLU in training, ConvBNReLU in predict mode)
# ---------------------------------------------------------------------------

def test_bnrelu_resnet_bf16_predict_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=3)
    x = images(3, 4)
    (truth,) = torch_forward(tnet, x)
    jnet.cast("bfloat16")
    tnet.to(BF16)
    want = jnet(nd.array(x).astype("bfloat16"))
    cbr.reset_counts()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x).to(BF16))
    ssa, mm = chip_smoke.bnrelu_launches(LAYERS)["predict"]
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == (ssa, mm)
    assert got.dtype == BF16
    close("predict logits", f32(got), f32(want), truth)


def resnet_step(net, x, y):
    """Loss, every gradient and the new moving statistics of one port
    training forward and backward."""
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    return (loss, {n: p.grad for n, p in net.named_parameters()},
            dict(net.named_buffers()))


def test_bnrelu_resnet_bf16_training_step_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=5)
    x = images(4, 6)
    y = np.random.RandomState(7).randint(0, CLASSES, 4).astype(np.int32)
    yt = torch.from_numpy(y)
    t_loss, t_grads, t_stats = resnet_step(copy.deepcopy(tnet),
                                           torch.from_numpy(x), yt)
    jnet.cast("bfloat16")
    tnet.to(BF16)
    with jautograd.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(nd.array(x).astype("bfloat16")), nd.array(y, dtype="int32"))
    jl.backward()
    cbr.reset_counts()
    tl, tgrads, tstats = resnet_step(tnet, torch.from_numpy(x).to(BF16), yt)
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == \
        chip_smoke.bnrelu_launches(LAYERS)["train"]
    assert tl.dtype == BF16
    close("loss", f32(tl), f32(jl), f32(t_loss))
    jp = jnet._collect_params_with_prefix()
    for name, g in tgrads.items():
        close(name, f32(g), f32(jp[name].grad()), f32(t_grads[name]))
    # the batch statistics reduce in bf16 (f32 sums) on both sides, and
    # the moving statistics stay bf16
    want = jax_moving_stats(jnet)
    assert sorted(want) == sorted(tstats)
    for name, b in tstats.items():
        assert b.dtype == BF16, name
        close(name, f32(b), np.asarray(want[name], np.float32),
              f32(t_stats[name]))


# ---------------------------------------------------------------------------
# FrozenModel(compute_dtype="bfloat16")
# ---------------------------------------------------------------------------

def test_frozen_resnet_compute_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet, _ = bnrelu_pair(seed=11)
    buckets = (1, 2, 4)
    jfm = JaxFrozenModel(jnet, input_shape=(32, 32, 3), dtype="float32",
                         batch_buckets=buckets, compute_dtype="bfloat16")
    fm = FrozenModel(tnet, input_shape=(32, 32, 3), dtype="float32",
                     batch_buckets=buckets, ctx=cpu(),
                     compute_dtype="bfloat16")
    assert fm._compute == BF16
    # cast once at freeze; the source module is untouched
    assert all(t.dtype == BF16 for t in fm._module.state_dict().values())
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    x = images(3, 12)
    (truth,) = torch_forward(tnet, x)
    cbr.reset_counts()
    (got,) = fm.predict_batch(x)
    ssa, mm = chip_smoke.bnrelu_launches(LAYERS)["predict"]
    assert (cbr.ssa_plain_calls, cbr.mm_plain_calls) == (ssa, mm)
    (want,) = jfm.predict_batch(x)
    assert got.dtype == want.dtype == np.float32
    close("frozen ResNet logits", got, want, truth)
    # exactly the module cast to bf16 by hand, on bf16 images
    ref = tnet.to(BF16)
    with torch.inference_mode():
        direct = ref(torch.from_numpy(x).to(BF16)).float().numpy()
    np.testing.assert_array_equal(got, direct)


def test_frozen_bert_compute_bf16_matches_jax_cast_and_keeps_ids():
    jnet, tnet = bert_pair(seed=2)
    fm = FrozenModel(tnet, input_shape=(16,), dtype="int32",
                     batch_buckets=(1, 2, 4), ctx=cpu(),
                     compute_dtype="bfloat16")
    ids = bert_ids(3)
    truth = torch_forward(tnet, ids)
    seq, pooled = fm.predict_batch(ids)
    # answers in float32 although the request is int32
    assert seq.dtype == pooled.dtype == np.float32
    assert seq.shape == (3, 16, 64) and pooled.shape == (3, 64)
    jnet.cast("bfloat16")
    seq_j, pooled_j = jnet(nd.array(ids, dtype="int32"))
    close("frozen BERT sequence output", seq, f32(seq_j), truth[0])
    close("frozen BERT pooled output", pooled, f32(pooled_j), truth[1])
    # ids above 256 stay exact: 257 and 258 are not 256 and 256
    a, b = ids[:1].copy(), ids[:1].copy()
    a[0, :2] = (257, 258)
    b[0, :2] = (256, 256)
    seq_a, _ = fm.predict_batch(a)
    seq_b, _ = fm.predict_batch(b)
    assert np.abs(seq_a[0, :2] - seq_b[0, :2]).max() > 0.1
    assert not np.array_equal(seq_a, seq_b)


def test_quantize_bf16_freezes_the_same_block_and_int8_is_not_ported():
    _, tnet, _ = bnrelu_pair(seed=13)
    fm = FrozenModel(tnet, input_shape=(32, 32, 3), batch_buckets=(1, 2),
                     ctx=cpu())
    q = fm.quantize("bf16")
    assert q._compute == BF16 and q.buckets == fm.buckets
    assert fm._compute is None
    assert "compute_dtype=bfloat16" in repr(q)
    x = images(2, 14)
    direct = FrozenModel(tnet, input_shape=(32, 32, 3), batch_buckets=(2,),
                         ctx=cpu(), compute_dtype="bf16").predict_batch(x)
    np.testing.assert_array_equal(q.predict_batch(x)[0], direct[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fm.quantize("int8")
    with pytest.raises(ValueError, match="quantize mode"):
        fm.quantize("fp8")
    with pytest.raises(ValueError, match="compute_dtype"):
        FrozenModel(tnet, input_shape=(32, 32, 3), batch_buckets=(1,),
                    ctx=cpu(), compute_dtype="float16")
