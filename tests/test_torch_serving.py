"""The port's serving stack (FrozenModel -> DynamicBatcher -> ModelServer)
against the JAX package's, on a small BERT with the same weights.

Everything runs on the CPU with ``ctx=cpu()``; the HTTP server binds
127.0.0.1 port 0.
"""
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu_torch import cpu
from incubator_mxnet_tpu_torch import profiler as prof
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.serving import (DeadlineExceededError,
                                               DynamicBatcher, FrozenModel,
                                               InvalidInputError,
                                               ModelServer, QueueFullError,
                                               ServerClosedError,
                                               default_buckets)

CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
           max_length=32, vocab_size=100, dropout=0.0)
L = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def nets():
    """(JAX BERT, port BERT) with the same random weights."""
    import incubator_mxnet_tpu as mx
    jnet = JaxBERT(**CFG)
    jnet.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(11)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = (0.3 * rng.randn(*p.shape)).astype(np.float32)
        if name.endswith("gamma"):
            a += 1.0
        p.set_data(nd.array(a))
        arrays[name] = a
    return jnet, load_jax_params(BERTModel(**CFG), arrays)


@pytest.fixture(scope="module")
def frozen(nets):
    return FrozenModel(nets[1], input_shape=(L,), dtype="int32",
                       batch_buckets=(1, 2, 4), ctx=cpu())


def ids(n, seed):
    return np.random.RandomState(seed).randint(0, 100, (n, L)).astype(
        np.int32)


def jax_forward(jnet, x):
    seq, pooled = jnet(nd.array(x, dtype="int32"))
    return seq.asnumpy(), pooled.asnumpy()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# FrozenModel
# ---------------------------------------------------------------------------

def test_frozen_predict_batch_matches_jax_freeze(nets, frozen, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet, _ = nets
    jfm = jnet.freeze(input_shape=(L,), dtype="int32",
                      batch_buckets=(1, 2, 4))
    for n in (1, 3):
        x = ids(n, n)
        timings = {}
        got = frozen.predict_batch(x, timings=timings)
        want = jfm.predict_batch(x)
        assert set(timings) == {"pad_ms", "exec_ms", "unpad_ms"}
        assert [g.shape for g in got] == [(n, L, 64), (n, 64)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


def test_frozen_buckets_padding_and_call(frozen):
    assert frozen.buckets == (1, 2, 4)
    assert (frozen.bucket_for(1), frozen.bucket_for(3)) == (1, 4)
    with pytest.raises(InvalidInputError):
        frozen.bucket_for(5)
    with pytest.raises(InvalidInputError):
        frozen.run_raw(ids(3, 0))       # 3 is not a bucket
    x = ids(3, 1)
    padded = frozen.predict_batch(x)[0]
    junk = frozen.predict_batch(np.concatenate([x, ids(1, 9)]))[0][:3]
    np.testing.assert_allclose(padded, junk, rtol=1e-6, atol=1e-6)
    seq, pooled = frozen(torch.from_numpy(x))
    assert isinstance(seq, torch.Tensor) and pooled.shape == (3, 64)
    assert default_buckets() == (1, 2, 4, 8, 16, 32)
    assert default_buckets(12) == (1, 2, 4, 8, 12)


def test_frozen_is_a_snapshot(nets):
    net = BERTModel(**CFG)
    net.load_state_dict(nets[1].state_dict())
    fm = FrozenModel(net, (L,), dtype="int32", batch_buckets=(2,),
                     ctx=cpu(), warmup=False)
    x = ids(2, 4)
    before = fm.predict_batch(x)[1]
    with torch.no_grad():
        net.pooler.weight.fill_(1.0)    # "train" the source
    np.testing.assert_array_equal(fm.predict_batch(x)[1], before)


def test_frozen_without_ctx_needs_a_card(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="ctx=cpu"):
        FrozenModel(nets[1], (L,), dtype="int32")


# ---------------------------------------------------------------------------
# ModelServer over HTTP
# ---------------------------------------------------------------------------

def test_server_concurrent_predicts_match_jax(nets, frozen, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    prof.reset_counters()
    srv = ModelServer(frozen, max_delay_ms=50, default_timeout_ms=30000)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    xs = ids(8, 21)
    results = [None] * 8

    def client(i):
        results[i] = _post(url + "/predict", {"data": xs[i].tolist()})

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        code, health = _get(url + "/healthz")
        assert (code, health["status"]) == (200, "ok")
        code, stats = _get(url + "/stats")
        assert code == 200
    finally:
        srv.stop()
    seq_j, pooled_j = jax_forward(nets[0], xs)
    for i, (code, doc) in enumerate(results):
        assert code == 200, doc
        seq, pooled = (np.asarray(o, np.float32) for o in doc["output"])
        np.testing.assert_allclose(seq, seq_j[i], **TOL)
        np.testing.assert_allclose(pooled, pooled_j[i], **TOL)
        assert 0 <= doc["batch_index"] < doc["batch_size"]
    assert stats["serving.requests"] == 8
    assert stats["serving.responses"] == 8
    assert stats["serving.batches"] < 8          # requests were coalesced
    assert stats["serving.latency_ms"]["count"] == 8
    assert stats["p50_ms"] is not None and stats["batch_fill"] > 1.0


def test_server_rejects_invalid_input_with_400(frozen):
    srv = ModelServer(frozen)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    try:
        code, doc = _post(url + "/predict", {"data": list(range(L + 1))})
        assert code == 400 and doc["error"] == "InvalidInputError"
        code, doc = _post(url + "/predict", {"nodata": 1})
        assert code == 400
        assert _get(url + "/nowhere")[0] == 404
    finally:
        srv.stop()
    assert _get_closed(url)


def _get_closed(url):
    try:
        urllib.request.urlopen(url + "/healthz", timeout=5)
    except (urllib.error.URLError, ConnectionError):
        return True
    return False


def test_server_queue_full_answers_429(frozen, monkeypatch):
    entered, release = threading.Event(), threading.Event()
    real = frozen.predict_batch

    def slow(x, timings=None):
        entered.set()
        release.wait(30)
        return real(x, timings)

    srv = ModelServer(frozen, max_delay_ms=0, queue_limit=1,
                      default_timeout_ms=30000)
    monkeypatch.setattr(srv.batcher.model, "predict_batch", slow)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    out = {}
    try:
        first = threading.Thread(target=lambda: out.setdefault(
            "a", _post(url + "/predict", {"data": ids(1, 1)[0].tolist()})))
        first.start()
        assert entered.wait(30)            # the dispatcher holds request a
        second = threading.Thread(target=lambda: out.setdefault(
            "b", _post(url + "/predict", {"data": ids(1, 2)[0].tolist()})))
        second.start()
        deadline = time.time() + 30
        while srv.batcher.queue_depth < 1 and time.time() < deadline:
            time.sleep(0.01)
        code, doc = _post(url + "/predict", {"data": ids(1, 3)[0].tolist()})
        assert (code, doc["error"]) == (429, "QueueFullError")
        release.set()
        first.join(60)
        second.join(60)
        assert out["a"][0] == 200 and out["b"][0] == 200
    finally:
        release.set()
        srv.stop()


def test_batcher_drains_every_accepted_request_on_stop(frozen):
    b = DynamicBatcher(frozen, max_delay_ms=1, queue_limit=64,
                       default_timeout_ms=60000)
    reqs = [b.submit(ids(1, i)[0]) for i in range(10)]   # queued, not started
    b.start()
    b.stop(drain=True)
    assert not b.running
    outs = [r.wait(5) for r in reqs]                     # none dropped
    assert all(o[0].shape == (L, 64) for o in outs)
    with pytest.raises(ServerClosedError):
        b.submit(ids(1, 0)[0])
    want = frozen.predict_batch(ids(1, 3))
    np.testing.assert_allclose(outs[3][1], want[1][0], rtol=1e-6, atol=1e-6)


def test_batcher_rejects_expired_and_full_and_flushes_without_drain(frozen):
    b = DynamicBatcher(frozen, queue_limit=2)
    expired = b.submit(ids(1, 0)[0], timeout_ms=1)
    kept = b.submit(ids(1, 1)[0], timeout_ms=60000)
    with pytest.raises(QueueFullError):
        b.submit(ids(1, 2)[0])
    with pytest.raises(InvalidInputError):
        b.submit(ids(1, 2)[0].astype(np.float32))
    time.sleep(0.01)
    b.start()
    with pytest.raises(DeadlineExceededError):
        expired.wait(10)
    assert kept.wait(10)[1].shape == (64,)
    late = b.submit(ids(1, 3)[0], timeout_ms=60000)
    b.stop(drain=False)
    try:                 # served before the stop, or rejected by it
        late.wait(5)
    except ServerClosedError:
        pass
    assert late.done


def test_stopped_server_frees_its_model_without_the_collector(nets):
    """A stopped ModelServer leaves no reference cycle behind: with Python's
    cyclic collector off, dropping the server and its FrozenModel frees the
    model at once. (On a card the model holds CUDA graphs; one that only
    the collector frees dies at whatever moment it runs, which can fall
    inside another capture and invalidate it.)"""
    gc.collect()
    was = gc.isenabled()
    before = set(threading.enumerate())
    gc.disable()
    try:
        fm = FrozenModel(nets[1], input_shape=(L,), dtype="int32",
                         batch_buckets=(1,), ctx=cpu())
        srv = ModelServer(fm)
        host, port = srv.start()
        code, doc = _post(f"http://{host}:{port}/predict",
                          {"data": ids(1, 5)[0].tolist()})
        assert code == 200 and doc["batch_size"] == 1
        srv.stop()
        # the request's handler thread may still be closing its connection
        deadline = time.time() + 30
        while (set(threading.enumerate()) - before
               and time.time() < deadline):
            time.sleep(0.01)
        assert not set(threading.enumerate()) - before
        model = weakref.ref(fm)
        del srv, fm
        assert model() is None
    finally:
        if was:
            gc.enable()
