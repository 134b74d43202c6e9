"""The port's BERT against the JAX package's, with the same weights.

A small JAX BERTModel is given random weights from numpy, its parameters
are carried into the port with ``convert.load_jax_params``, and both run the
same (3, 16) int32 batch. On the JAX side the Pallas kernels are selected
(``MXTPU_PALLAS=force``, interpret mode on the CPU); on the port's side the
CPU tensors take the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import profiler as jax_prof
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu_torch import ops
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.bert import BERTModel, get_bert_model
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln

CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
           max_length=32, vocab_size=100, dropout=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_params(net, seed):
    """Random weights (not the near-uniform Normal(0.02)) so attention and
    the layer norms see real spread; returns them as numpy arrays."""
    net.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        leaf = name.rsplit(".", 1)[-1]
        a = rng.randn(*p.shape).astype(np.float32)
        a = 1.0 + 0.1 * a if leaf == "gamma" else (
            0.1 * a if leaf in ("beta", "bias") else 0.3 * a)
        p.set_data(nd.array(a))
        arrays[name] = a
    return arrays


def pair(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jnet = JaxBERT(**cfg)
    arrays = jax_params(jnet, seed)
    tnet = load_jax_params(BERTModel(**cfg), arrays).eval()
    return jnet, tnet


def batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 100, (3, 16)).astype(np.int32),
            rng.randint(0, 2, (3, 16)).astype(np.int32))


def run_jax(net, ids, tt=None, vl=None):
    seq, pooled = net(nd.array(ids, dtype="int32"),
                      None if tt is None else nd.array(tt, dtype="int32"),
                      None if vl is None else nd.array(vl, dtype="int32"))
    return seq.asnumpy(), pooled.asnumpy()


def run_torch(net, ids, tt=None, vl=None):
    with torch.inference_mode():
        seq, pooled = net(torch.from_numpy(ids),
                          None if tt is None else torch.from_numpy(tt),
                          None if vl is None else torch.from_numpy(vl))
    return seq.numpy(), pooled.numpy()


@pytest.mark.parametrize("pre_norm", [False, True])
def test_bert_matches_jax_with_kernels_selected(monkeypatch, pre_norm):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet = pair(pre_norm=pre_norm)
    ids, tt = batch()
    jax_prof.reset_counters()
    seq_j, pooled_j = run_jax(jnet, ids, tt)
    sel = jax_prof.counters()
    assert sel.get("ops/pallas.selected.flash_attention") == 2
    assert sel.get("ops/pallas.selected.layer_norm") == 5
    fa.reset_counts()
    ln.reset_counts()
    seq_t, pooled_t = run_torch(tnet, ids, tt)
    # the port took the kernels' route: 2 attentions, 2*2+1 layer norms
    assert (fa.launches, fa.plain_calls) == (0, 2)
    assert (ln.launches, ln.plain_calls) == (0, 5)
    assert seq_t.shape == (3, 16, 64) and pooled_t.shape == (3, 64)
    np.testing.assert_allclose(seq_t, seq_j, **TOL)
    np.testing.assert_allclose(pooled_t, pooled_j, **TOL)


def test_bert_valid_length_takes_masked_path_and_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, tnet = pair(seed=3)
    ids, tt = batch(2)
    vl = np.array([16, 9, 4], np.int32)
    seq_j, pooled_j = run_jax(jnet, ids, tt, vl)
    fa.reset_counts()
    seq_t, pooled_t = run_torch(tnet, ids, tt, vl)
    assert (fa.launches, fa.plain_calls) == (0, 0)   # masked: plain path
    np.testing.assert_allclose(seq_t, seq_j, **TOL)
    np.testing.assert_allclose(pooled_t, pooled_j, **TOL)


def test_bert_plain_jax_path_agrees_too(monkeypatch):
    # the JAX package's own XLA path (kernels off) is the same function
    monkeypatch.setenv("MXTPU_PALLAS", "0")
    jnet, tnet = pair(seed=4)
    ids, tt = batch(5)
    for a, b in zip(run_torch(tnet, ids, tt), run_jax(jnet, ids, tt)):
        np.testing.assert_allclose(a, b, **TOL)


def test_load_jax_params_rejects_missing_extra_and_misshaped():
    jnet = JaxBERT(**CFG)
    arrays = jax_params(jnet, 0)
    tnet = BERTModel(**CFG)
    missing = dict(arrays)
    del missing["encoder.cells.1.ln2.beta"]
    with pytest.raises(ValueError, match="missing.*ln2.beta"):
        load_jax_params(tnet, missing)
    extra = dict(arrays, **{"encoder.cells.2.ln1.gamma": np.ones(64)})
    with pytest.raises(ValueError, match="extra.*cells.2"):
        load_jax_params(tnet, extra)
    bad = dict(arrays, **{"pooler.weight": np.zeros((64, 63), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch.*pooler.weight"):
        load_jax_params(tnet, bad)
    # nothing was copied by the failed calls
    assert float(tnet.pooler.weight.detach().abs().sum()) == 0.0
    load_jax_params(tnet, arrays)
    np.testing.assert_array_equal(tnet.pooler.weight.detach().numpy(),
                                  arrays["pooler.weight"])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_matches_jax(monkeypatch, masked, causal):
    """No mask: the flash route on both sides; a mask: the plain masked
    softmax path (with the causal triangle folded in)."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu.ops import _raw as jraw
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 12, 32).astype(np.float32) for _ in range(3))
    keep = rng.rand(2, 1, 12, 12) > 0.3 if masked else None
    if masked:
        keep[..., 0] = True           # every row sees at least one key
    ref = jraw.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
        None if keep is None else jnp.asarray(keep), causal=causal)
    fa.reset_counts()
    out = ops.multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4,
        None if keep is None else torch.from_numpy(keep), causal=causal)
    assert fa.plain_calls == (0 if masked else 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_connected_flattens_like_jax():
    from incubator_mxnet_tpu.ops import _raw as jraw
    rng = np.random.RandomState(8)
    x = rng.randn(3, 4, 5).astype(np.float32)
    w = rng.randn(6, 20).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ref = np.asarray(jraw.dense(x, w, b, flatten=True))
    out = ops.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), flatten=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    w2 = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_allclose(
        ops.fully_connected(torch.from_numpy(x), torch.from_numpy(w2),
                            flatten=False).numpy(),
        np.asarray(jraw.dense(x, w2, None, flatten=False)),
        rtol=1e-5, atol=1e-5)


def test_embedding_id_policy_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(10, 4).astype(np.float32)
    ids = np.array([[0.0, 2.5, 3.5, 4.49], [9.6, -3.0, 12.0, 1.51]],
                   np.float32)
    ref = nd.embedding(nd.array(ids), nd.array(w)).asnumpy()
    out = ops.embedding(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out, ref)
    int_ids = np.array([[1, 99], [-5, 3]], np.int64)
    np.testing.assert_array_equal(
        ops.embedding(torch.from_numpy(int_ids), torch.from_numpy(w)).numpy(),
        nd.embedding(nd.array(int_ids, dtype="int32"),
                     nd.array(w)).asnumpy())


def test_gelu_is_the_erf_form_of_the_jax_layer():
    from incubator_mxnet_tpu.gluon import nn as jnn
    from incubator_mxnet_tpu_torch.gluon import nn as tnn
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = jnn.GELU()(nd.array(x)).asnumpy()
    out = tnn.GELU()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_get_bert_model_needs_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="ctx=cpu"):
        get_bert_model("bert_12_768_12")
    from incubator_mxnet_tpu_torch import cpu
    net = get_bert_model("bert_12_768_12", vocab_size=50, max_length=16,
                         ctx=cpu(), seed=0)
    assert not net.training
    assert net.encoder.cells[0].attention.qkv.weight.shape == (2304, 768)
    assert len(net.encoder.cells) == 12
