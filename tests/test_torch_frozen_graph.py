"""FrozenModel's graph bookkeeping on the CPU: the launch counts a CUDA graph
replay credits (``ops.cuda.launch_counts``, ``add_launch_counts``,
``launch_delta``), the garbage collector held off while FrozenModel and
FusedTrainStep capture (``gc_paused``, under a stand-in for
``torch.cuda``'s capture), the eager CPU path against the JAX FrozenModel,
and the report of ``tools/ab_resnet.py``.

A graph is captured and replayed only on a card (``chip_smoke.py`` holds
that path there); here FrozenModel runs eagerly, as ``ctx=cpu()`` asks.
"""
import contextlib
import gc
import json

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu_torch import cpu
from incubator_mxnet_tpu_torch import profiler as prof
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.ops import cuda as ocuda
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
from incubator_mxnet_tpu_torch.parallel import FusedTrainStep
from incubator_mxnet_tpu_torch.serving import FrozenModel
from incubator_mxnet_tpu_torch.tools import ab_resnet

CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
           max_length=32, vocab_size=100, dropout=0.0)
L = 16
TOL = dict(rtol=1e-4, atol=1e-4)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layer_norm",
           "scale_shift_act", "mm_epilogue", "mm_wgmma", "mm_splitk_reduce")


@pytest.fixture(autouse=True)
def zero_counts():
    for mod in (fa, ln, cbr):
        mod.reset_counts()
    yield
    for mod in (fa, ln, cbr):
        mod.reset_counts()


@pytest.fixture(scope="module")
def nets():
    """(JAX BERT, port BERT) with the same random weights."""
    import incubator_mxnet_tpu as mx
    jnet = JaxBERT(**CFG)
    jnet.initialize(init=mx.init.Normal(0.02))
    rng = np.random.RandomState(13)
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = (0.3 * rng.randn(*p.shape)).astype(np.float32)
        if name.endswith("gamma"):
            a += 1.0
        p.set_data(nd.array(a))
        arrays[name] = a
    return jnet, load_jax_params(BERTModel(**CFG), arrays)


def ids(n, seed):
    return np.random.RandomState(seed).randint(0, 100, (n, L)).astype(
        np.int32)


def test_launch_counts_name_every_kernel_and_read_the_wrappers():
    counts = ocuda.launch_counts()
    assert tuple(counts) == KERNELS
    assert all(v == (0, 0) for v in counts.values())
    fa.launches, cbr.mm_reduce_plain_calls = 3, 2
    counts = ocuda.launch_counts()
    assert counts["flash_fwd"] == (3, 0)
    assert counts["mm_splitk_reduce"] == (0, 2)


@pytest.mark.parametrize("replays", [1, 3, 7])
def test_add_launch_counts_adds_one_delta_a_replay(replays):
    delta = {"flash_fwd": (12, 0), "layer_norm": (25, 0),
             "mm_splitk_reduce": (13, 0)}
    ln.launches, ln.plain_calls = 4, 1
    for _ in range(replays):
        ocuda.add_launch_counts(delta)
    counts = ocuda.launch_counts()
    assert counts["flash_fwd"] == (12 * replays, 0)
    assert counts["layer_norm"] == (4 + 25 * replays, 1)
    assert counts["mm_splitk_reduce"] == (13 * replays, 0)
    assert all(counts[k] == (0, 0) for k in KERNELS
               if k not in ("flash_fwd", "layer_norm", "mm_splitk_reduce"))


@pytest.mark.parametrize("delta", [
    {"flash_fwd": (12, 1)},
    {"layer_norm": (0, 25)},
    {"flash_fwd": (12, 0), "mm_epilogue": (30, 2)},
])
def test_a_delta_with_plain_calls_cannot_be_credited(delta):
    with pytest.raises(ValueError, match="plain calls"):
        ocuda.add_launch_counts(delta)
    assert all(v == (0, 0) for v in ocuda.launch_counts().values())


def test_the_wgmma_gemm_is_credited_and_shares_the_gemms_plain_count():
    """Both GEMM routes have one plain version, counted under
    mm_epilogue: mm_wgmma reads its launches and no plain calls, a replay
    credits it, and launch_delta puts it back."""
    cbr.mm_wgmma_launches, cbr.mm_plain_calls = 2, 5
    assert ocuda.launch_counts()["mm_wgmma"] == (2, 0)
    assert ocuda.launch_counts()["mm_epilogue"] == (0, 5)
    ocuda.add_launch_counts({"mm_wgmma": (30, 0), "mm_splitk_reduce": (7, 0)})
    assert ocuda.launch_counts()["mm_wgmma"] == (32, 0)
    with ocuda.launch_delta() as delta:
        cbr.mm_wgmma_launches += 3
    assert delta["mm_wgmma"] == (3, 0)
    assert cbr.mm_wgmma_launches == 32 and cbr.mm_plain_calls == 5


def test_a_delta_of_an_unknown_kernel_raises():
    with pytest.raises(KeyError, match="no kernel"):
        ocuda.add_launch_counts({"flash": (1, 0)})


def test_launch_delta_takes_a_forward_back_out_and_returns_it(nets):
    """What a capture does with the counters: the forward's counts come
    back as the delta and leave the counters where they stood. On the CPU
    every call is plain: 2L + 1 layer norms and L attentions."""
    net = nets[1]
    fa.launches, ln.plain_calls = 5, 7
    before = ocuda.launch_counts()
    with ocuda.launch_delta() as delta, torch.inference_mode():
        net(torch.from_numpy(ids(2, 3)))
    assert ocuda.launch_counts() == before
    layers = CFG["num_layers"]
    assert delta["layer_norm"] == (0, 2 * layers + 1)
    assert delta["flash_fwd"] == (0, layers)
    assert all(delta[k] == (0, 0) for k in KERNELS
               if k not in ("layer_norm", "flash_fwd"))
    with pytest.raises(ValueError, match="plain calls"):
        ocuda.add_launch_counts(delta)


def test_launch_delta_restores_the_counters_when_the_body_raises(nets):
    before = ocuda.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        with ocuda.launch_delta():
            with torch.inference_mode():
                nets[1](torch.from_numpy(ids(1, 4)))
            raise RuntimeError("capture failed")
    assert ocuda.launch_counts() == before


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_paused_holds_the_collector_off_and_puts_it_back(enabled):
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with ocuda.gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError, match="capture failed"):
            with ocuda.gc_paused():
                raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


class _Stream:
    def __init__(self, *args, **kw):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    def register_generator_state(self, gen):
        self.generators = getattr(self, "generators", []) + [gen]


@pytest.fixture
def fake_capture(monkeypatch):
    """``torch.cuda``'s streams, events and capture stood in for: the
    capture runs its body eagerly and records whether the collector was on
    at its entry and at its exit."""
    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None, **kw):
        seen.append(gc.isenabled())
        yield
        seen.append(gc.isenabled())

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Event", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a: self)
    return seen


@pytest.mark.parametrize("which", ["frozen_model", "fused_train_step"])
def test_a_capture_runs_with_the_collector_paused(fake_capture, which):
    """A graph that dies in a reference cycle and is collected during
    another capture invalidates that capture (on an H100: "operation
    failed due to a previous error during capture"), so both captures
    hold the collector off, and put it back after."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 5))
    gc.enable()
    if which == "frozen_model":
        fm = FrozenModel(net, input_shape=(8,), dtype="float32",
                         batch_buckets=(2,), ctx=cpu(), warmup=False)
        g = fm._capture(2, None)
        assert g.delta == {k: (0, 0) for k in KERNELS}
        # the model's own generator, registered before the capture
        assert g.graph.generators == [fm._gen]
    else:
        from incubator_mxnet_tpu_torch import gluon, optimizer
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1))
        step._resolve()
        step._pool = None
        g = step._capture(torch.zeros(2, 8), torch.zeros(2, dtype=torch.int32))
        assert torch.isfinite(g.loss)
        # the device's seeded generator, registered before the capture
        from incubator_mxnet_tpu_torch import random
        assert g.graph.generators == [random.generator(cpu())]
    assert fake_capture == [False, False]
    assert gc.isenabled()


@pytest.mark.parametrize("n", [1, 3, 4])
def test_cpu_frozen_model_runs_eagerly_and_matches_jax(nets, monkeypatch, n):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    prof.reset_counters()
    jnet, net = nets
    fm = FrozenModel(net, input_shape=(L,), dtype="int32",
                     batch_buckets=(1, 2, 4), ctx=cpu())
    # nothing is captured on the CPU: no graph, no compile
    counters = prof.counters()
    assert counters["serving/serving.compiled_buckets"] == 0
    assert "serving/serving.compiles" not in counters
    assert counters["serving/serving.warmup_runs"] == 3
    jfm = jnet.freeze(input_shape=(L,), dtype="int32",
                      batch_buckets=(1, 2, 4))
    x = ids(n, 20 + n)
    got = fm.predict_batch(x)
    want = jfm.predict_batch(x)
    assert [g.shape for g in got] == [(n, L, 64), (n, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    b = fm.bucket_for(n)
    padded = np.concatenate([x, np.zeros((b - n, L), np.int32)])
    for r, e in zip(fm.run_raw(padded), fm.run_eager(padded)):
        np.testing.assert_array_equal(r.numpy(), e.numpy())


def test_run_raw_refuses_a_batch_of_another_sample_shape(nets):
    from incubator_mxnet_tpu_torch.serving import InvalidInputError
    fm = FrozenModel(nets[1], input_shape=(L,), dtype="int32",
                     batch_buckets=(2,), ctx=cpu(), warmup=False)
    with pytest.raises(InvalidInputError, match="sample shape"):
        fm.run_raw(np.zeros((2, L + 1), np.int32))


def _resnet_side(exec1, bert1):
    buckets = lambda ms: {  # noqa: E731
        "freeze_s": 3.0,
        "buckets": {str(b): {"exec_ms_median": ms * b, "exec_ms": [ms * b],
                             "device": [{"ms": ms, "events": 10},
                                        {"ms": ms / 2, "events": 5}]}
                    for b in (1, 32)}}
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "gemms": [{"case": "s4_conv1_b1", "dtype": "float32",
                       "bucket": 1, "ms": 0.1, "short_traces": 0,
                       "per_forward": 2}],
            "forward_gemm_ms": {"float32": None, "bfloat16": None},
            "serving": {"images_per_s": 300.0, "mean_batch": 8.0,
                        "latency_p50_ms": 15.0},
            "exec": buckets(exec1), "bert_exec": buckets(bert1)}


def test_resnet_report_reads_both_models_exec_ms(tmp_path, capsys):
    runs = [("pr7", _resnet_side(12.9, 5.0)), ("new", _resnet_side(3.0, 2.5)),
            ("new", _resnet_side(3.2, 2.6)), ("pr7", _resnet_side(11.0, 2.0))]
    path = tmp_path / "ab.json"
    path.write_text(json.dumps([{"label": lab, **r} for lab, r in runs]))
    assert ab_resnet.main(["--report", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    line = {ln.split(":")[0]: ln for ln in out}
    assert line["exec_ms bucket 1"] == (
        "exec_ms bucket 1: | pr7 12.9, 11 | pr7 quartiles 11/11.95/12.9 "
        "| new 3, 3.2 | new quartiles 3/3.1/3.2 | new lower in 2 of 2")
    # BERT's round 2: 2.6 against 2.0
    assert line["bert exec_ms bucket 1"].endswith("new lower in 1 of 2")
    assert line["bert exec_ms bucket 32"].startswith(
        "bert exec_ms bucket 32: | pr7 160, 64 |")
    # a forward's device time is the trace with the most events
    assert line["forward device ms bucket 32"].startswith(
        "forward device ms bucket 32: | pr7 12.9, 11 |")
    assert line["bert freeze_s"].endswith("new lower in 0 of 2")
    assert ("forward traces new bert_exec bucket 1: 2 of 4 short (fewer "
            "than 10 events)") in out


def test_frozen_dropout_always_draws_one_fixed_mask(monkeypatch):
    """A frozen module whose dropout runs always (``mode="always"``) answers
    the same twice, as the JAX FrozenModel's fixed PRNGKey(0) makes it: the
    model's own generator, set back to its seed before each call, draws the
    mask. The mask is real (the answer is not the rate-0 one), and the
    device's own generator is neither drawn from nor moved."""
    from incubator_mxnet_tpu_torch import gluon, random

    def net(rate):
        torch.manual_seed(0)
        return torch.nn.Sequential(
            torch.nn.Linear(8, 32), gluon.nn.Dropout(rate, mode="always"),
            torch.nn.ReLU(), torch.nn.Linear(32, 4))

    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    state = random.generator(cpu()).get_state()
    fm = FrozenModel(net(0.5), input_shape=(8,), dtype="float32",
                     batch_buckets=(4,), ctx=cpu())
    first, again = fm.predict_batch(x)[0], fm.predict_batch(x)[0]
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(fm.run_eager(x)[0].numpy(), first)
    assert torch.equal(random.generator(cpu()).get_state(), state)
    no_drop = FrozenModel(net(0.0), input_shape=(8,), dtype="float32",
                          batch_buckets=(4,), ctx=cpu()).predict_batch(x)[0]
    assert np.abs(first - no_drop).max() > 1e-3
    # the mask is the one a generator at FROZEN_SEED draws
    from incubator_mxnet_tpu_torch.serving.frozen import FROZEN_SEED
    g = torch.Generator().manual_seed(FROZEN_SEED)
    with random.using(g), torch.no_grad():
        want = net(0.5)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(first, want)
