"""The port's ``Context`` against the JAX package's, on the CPU: value
equality and hashing, ``with`` scopes (nested, per thread), ``nd.zeros``
inside a scope, ``Parameter.list_ctx`` and the module's functions.

Both packages' contexts are compared by ``repr`` (``cpu(0)``): the two
classes differ, the values must not. Outside every scope the default
differs by design (the JAX package's first device, the CPU here; the
port's ``gpu(0)``), so the scope tests compare only what a scope sets.
"""
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import context as jcontext
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import context, cpu, gluon, gpu, nd, tpu

PAIRS = {
    "cpu_cpu": ("cpu()", "cpu()"),
    "cpu0_cpu1": ("cpu(0)", "cpu(1)"),
    "gpu0_gpu0": ("gpu(0)", "gpu(0)"),
    "gpu0_tpu0": ("gpu(0)", "tpu(0)"),
    "gpu0_gpu1": ("gpu(0)", "gpu(1)"),
    "tpu1_tpu1": ("tpu(1)", "tpu(1)"),
}


def _make(module, text):
    name, arg = text[:-1].split("(")
    return getattr(module, name)(*([int(arg)] if arg else []))


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_equality_and_hash_match_the_jax_package(pair):
    a, b = PAIRS[pair]
    ja, jb = _make(mx, a), _make(mx, b)
    ta, tb = _make(context, a), _make(context, b)
    assert (ta == tb) == (ja == jb)
    assert (ta != tb) == (ja != jb)
    assert (hash(ta) == hash(tb)) == (hash(ja) == hash(jb))
    assert repr(ta) == repr(ja) and repr(tb) == repr(jb)
    assert ta != repr(ta) and ja != repr(ja)


def test_sets_and_dicts_key_by_value():
    made = ["cpu()", "cpu(0)", "gpu(0)", "gpu(0)", "tpu(1)", "cpu(1)"]
    jset = {_make(mx, m) for m in made}
    tset = {_make(context, m) for m in made}
    assert len(tset) == len(jset) == 4
    assert sorted(map(repr, tset)) == sorted(map(repr, jset))
    assert len({gpu(0), gpu(0)}) == 1
    d = {cpu(): "host"}
    assert d[cpu(0)] == "host" and gpu(0) not in d


def _scope_trace(module):
    """current_context() at each step of a nested scope sequence."""
    seen = []
    with module.cpu(1):
        seen.append(repr(module.current_context()))
        with module.gpu(0):
            seen.append(repr(module.current_context()))
            with module.cpu(0) as c:
                seen.append(repr(module.current_context()))
                seen.append(repr(c))
            seen.append(repr(module.Context.current()))
        seen.append(repr(module.current_context()))
    return seen


def test_nested_scopes_match_the_jax_package():
    got = _scope_trace(context)
    assert got == _scope_trace(jcontext)
    assert got == ["cpu(1)", "gpu(0)", "cpu(0)", "cpu(0)", "gpu(0)",
                   "cpu(1)"]
    assert context.current_context() == context.default_context() == gpu(0)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_a_scope_is_per_thread(side):
    module = context if side == "port" else jcontext
    default = repr(module.current_context())
    seen = {}
    inside = threading.Event()
    done = threading.Event()

    def other():
        inside.wait(10)
        seen["other"] = repr(module.current_context())
        with module.cpu(3):
            seen["other_scoped"] = repr(module.current_context())
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with module.cpu(2):
        inside.set()
        done.wait(10)
        seen["main"] = repr(module.current_context())
    t.join(10)
    assert seen == {"other": default, "other_scoped": "cpu(3)",
                    "main": "cpu(2)"}


def test_nd_zeros_lands_in_the_scope():
    with mx.cpu():
        jz = jnd.zeros((2,))
    with cpu():
        tz = nd.zeros((2,))
        ta = nd.array(np.ones(3))
    assert tz.context == cpu() == ta.context
    assert repr(tz.context) == repr(jz.context) == "cpu(0)"
    assert isinstance(tz.context, context.Context)


def test_list_ctx_returns_contexts_as_the_jax_package():
    jd = mx.gluon.nn.Dense(3, in_units=4)
    jd.initialize(ctx=mx.cpu())
    td = gluon.nn.Dense(3, in_units=4)
    td.initialize(ctx=cpu())
    for name in ("weight", "bias"):
        jl = jd.collect_params()[jd.prefix + name].list_ctx()
        tl = td.collect_params()[td.prefix + name].list_ctx()
        assert [repr(c) for c in tl] == [repr(c) for c in jl] == ["cpu(0)"]
        assert all(isinstance(c, context.Context) for c in tl)
        assert tl == [cpu()]


def test_module_functions():
    assert context.ctx_from_device(torch.device("cpu")) == cpu()
    assert context.ctx_from_device("cuda:1") == gpu(1)
    assert context.num_gpus() == context.num_tpus() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    with cpu(0):
        assert context.as_context(None) == cpu()
    assert context.as_context(tpu(2)) == tpu(2)
    with pytest.raises(TypeError):
        context.as_context("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            context.gpu_memory_info(0)
        with pytest.raises(RuntimeError, match="ctx=cpu"):
            gpu(0).device
