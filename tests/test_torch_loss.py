"""The port's Gluon losses are HybridBlocks, as the JAX package's are.

``SoftmaxCrossEntropyLoss`` (sparse and dense labels, ``from_logits``,
``weight``, ``sample_weight``, ``batch_axis``) and ``BERTPretrainLoss``
from seeded numpy inputs, eager and hybridized, against the JAX package's
losses (f32 sums in other orders: 1e-5); the hybridized value (one CUDA
graph a signature, faked on the CPU by ``test_torch_block``'s
``fake_card``) equals the eager one to 1e-6. ``collect_params()`` is an
empty ``ParameterDict`` and ``initialize()`` runs. A hybridized loss under
``autograd.record()``, inside another capture and inside a
``FusedTrainStep`` runs op by op: it never starts a capture of its own
there.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu_torch import autograd, cpu, gluon, models
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.parameter import ParameterDict
from incubator_mxnet_tpu_torch.parallel import FusedTrainStep
from test_torch_block import _FakeGraph, fake_card  # noqa: F401

TOL = 1e-5          # against the JAX package: f32 sums in other orders
HYBRID_TOL = 1e-6   # hybridized against eager: the same ops

N, T, C = 4, 6, 10


def _log_softmax(x, axis=-1):
    x = x - x.max(axis, keepdims=True)
    return x - np.log(np.exp(x).sum(axis, keepdims=True))


def sce_case(name, seed=0):
    """(constructor kwargs, pred, label, sample_weight or None) of one
    SoftmaxCrossEntropyLoss case, numpy f32 (labels int32 when sparse)."""
    rs = np.random.RandomState(seed)
    pred = rs.randn(N, T, C).astype(np.float32)
    ids = rs.randint(0, C, size=(N, T)).astype(np.int32)
    dist = np.exp(_log_softmax(rs.randn(N, T, C))).astype(np.float32)
    sw = rs.rand(N, T).astype(np.float32)
    logp = _log_softmax(pred).astype(np.float32)
    return {
        "sparse": ({}, pred, ids, None),
        "dense": (dict(sparse_label=False), pred, dist, None),
        "from_logits_sparse": (dict(from_logits=True), logp, ids, None),
        "from_logits_dense": (dict(from_logits=True, sparse_label=False),
                              logp, dist, None),
        "sample_weight": ({}, pred, ids, sw),
        "weight_batch_axis": (dict(weight=0.5, batch_axis=1), pred, ids,
                              None),
        "axis_1": (dict(axis=1), pred.transpose(0, 2, 1).copy(), ids, None),
    }[name]


SCE_CASES = ("sparse", "dense", "from_logits_sparse", "from_logits_dense",
             "sample_weight", "weight_batch_axis", "axis_1")


def _jax_sce(kw, pred, label, sw):
    loss = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)
    args = [nd.array(pred), nd.array(label, dtype=str(label.dtype))]
    if sw is not None:
        args.append(nd.array(sw))
    return loss(*args).asnumpy()


def _args(*arrays):
    return [torch.from_numpy(a) for a in arrays if a is not None]


def _hybridized(loss, args):
    """`loss` hybridized on the faked card: the first call captures, the
    second replays; both answers are returned."""
    loss.hybridize()
    first = loss(*args)
    again = loss(*args)
    assert loss.captures == 1, "one graph for one signature"
    assert torch.equal(first, again)
    return first


@pytest.mark.parametrize("form", ["eager", "hybridized"])
@pytest.mark.parametrize("case", SCE_CASES)
def test_softmax_ce_matches_the_jax_package(case, form, fake_card):  # noqa: F811
    kw, pred, label, sw = sce_case(case)
    want = _jax_sce(kw, pred, label, sw)
    loss = gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    args = _args(pred, label, sw)
    eager = loss(*args)
    got = _hybridized(loss, args) if form == "hybridized" else eager
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert float((got - eager).abs().max()) <= HYBRID_TOL


def bert_inputs(seed=0, batch=3, masked=5, vocab=30):
    rs = np.random.RandomState(seed)
    mlm = rs.randn(batch, masked, vocab).astype(np.float32)
    nsp = rs.randn(batch, 2).astype(np.float32)
    lab = rs.randint(0, vocab, size=(batch, masked)).astype(np.int32)
    lab[0, 3:] = -1         # padded masked positions are ignored
    lab[2, 1] = -1
    nsp_lab = rs.randint(0, 2, size=(batch,)).astype(np.int32)
    return mlm, nsp, lab, nsp_lab


@pytest.mark.parametrize("form", ["eager", "hybridized"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bert_pretrain_loss_matches_the_jax_package(seed, form, fake_card):  # noqa: F811
    mlm, nsp, lab, nsp_lab = bert_inputs(seed)
    want = jbert.BERTPretrainLoss()(
        nd.array(mlm), nd.array(nsp), nd.array(lab, dtype="int32"),
        nd.array(nsp_lab, dtype="int32")).asnumpy()
    loss = models.BERTPretrainLoss()
    args = _args(mlm, nsp, lab, nsp_lab)
    eager = loss(*args)
    got = _hybridized(loss, args) if form == "hybridized" else eager
    assert got.shape == () and want.shape in ((), (1,))
    np.testing.assert_allclose(float(got), float(want.reshape(())),
                               rtol=TOL, atol=TOL)
    assert abs(float(got) - float(eager)) <= HYBRID_TOL


@pytest.mark.parametrize("make", [gluon.loss.SoftmaxCrossEntropyLoss,
                                  gluon.loss.SoftmaxCELoss,
                                  models.BERTPretrainLoss],
                         ids=["SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
                              "BERTPretrainLoss"])
def test_a_loss_is_a_hybrid_block(make):
    """What raised AttributeError while Loss was a plain torch Module."""
    loss = make()
    assert isinstance(loss, gluon.HybridBlock)
    assert isinstance(loss, gluon.loss.Loss)
    params = loss.collect_params()
    assert isinstance(params, ParameterDict) and len(params) == 0
    loss.initialize(ctx=cpu())
    loss.hybridize()
    loss.hybridize(False)
    assert loss.prefix and loss.name
    # the JAX package's constructor: weight, batch_axis, prefix, params
    named = gluon.loss.Loss(0.5, 1, prefix="my_loss_")
    assert (named.prefix, named._weight, named._batch_axis) == (
        "my_loss_", 0.5, 1)


def test_hybridized_loss_under_record_runs_op_by_op(fake_card):  # noqa: F811
    """Under record() a hybridized loss takes no graph (a graph's outputs
    carry no gradient) and backpropagates as the eager loss does."""
    kw, pred, label, _ = sce_case("sparse", seed=3)
    loss = gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    grads = []
    for hybrid in (False, True):
        loss.hybridize(hybrid)
        x = torch.from_numpy(pred).requires_grad_()
        with autograd.record():
            out = loss(x, torch.from_numpy(label))
        autograd.backward(out)
        grads.append(x.grad)
    assert loss.captures == 0 and _FakeGraph.replays == 0
    assert torch.equal(grads[0], grads[1])


def test_hybridized_loss_inside_a_capture_runs_op_by_op(fake_card,  # noqa: F811
                                                        monkeypatch):
    """Called while another graph is being captured (FrozenModel's bucket,
    FusedTrainStep's step), a hybridized loss runs eagerly into that
    capture: no nested capture."""
    kw, pred, label, _ = sce_case("dense", seed=4)
    loss = gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    args = _args(pred, label)
    eager = loss(*args)
    loss.hybridize()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert torch.equal(loss(*args), eager)
    assert loss.captures == 0


def test_hybridized_loss_in_a_fused_train_step(fake_card):  # noqa: F811
    """FusedTrainStep calls its loss under record(): a hybridized loss
    there captures nothing and gives the steps of an eager one."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(8, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 3, size=(8,)).astype(np.int64))
    losses = []
    for hybrid in (False, True):
        net = nn.Dense(3, in_units=6)
        net.initialize(ctx=cpu())
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(
                np.random.RandomState(6).randn(3, 6).astype(np.float32)))
            net.bias.zero_()
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize(hybrid)
        step = FusedTrainStep(net, loss_fn, "sgd")
        losses.append([float(step(x, y)) for _ in range(3)])
        assert loss_fn.captures == 0
    assert losses[0] == losses[1]
    assert losses[0][2] < losses[0][0]
