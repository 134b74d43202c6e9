"""float16 through the port against the JAX package: each kernel module's
plain version, a small BERT's forward and a small LM's amp step.

Every Pallas kernel computes in f32 and casts to its input's dtype, and
the JAX package runs them on float16 as on any float type. The port's
kernels take float16 on the card through the same code as bfloat16 (one
template a kernel row); on the CPU the wrappers run their plain versions,
which compute in ``promote_types(dtype, float32)`` and round where the
Pallas kernels round. The same numpy inputs go to both sides, rounded to
f16 to nearest even by both.

Tolerances. A kernel's f16 output rounds once from f32 sums taken in other
orders on the two sides, so the two land at most one f16 unit apart
(2**-10 of the value): ``TOL16``, against bf16's 3e-2 in
``test_torch_kernels.py``. The models are held as ``test_torch_bf16.py``
holds bf16, two ways against the port's f32 result from the same weights:
the port's f16 result no further from it than 1.5 times the JAX package's
f16 result plus 5e-3 (relative norms), and the two f16 results within
0.25 of the JAX one's norm of each other (f16 keeps 11 significant bits to
bf16's 8, so those bounds are no looser than bf16's).
"""
import copy
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_flash
from incubator_mxnet_tpu.ops.pallas import layer_norm as jax_layer_norm
from incubator_mxnet_tpu_torch import amp, autograd, cpu, gluon
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_loss
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln
from incubator_mxnet_tpu_torch.serving import FrozenModel

from test_torch_bf16 import BERT, LM, bert_ids, close, f32, jax_random

jcbr = importlib.import_module("incubator_mxnet_tpu.ops.pallas.conv_bn_relu")

F16 = torch.float16
TOL16 = dict(rtol=2 ** -10, atol=2e-3)
CSRC = Path(cbr.__file__).parent / "csrc"


def both(a):
    """One numpy array as (jax array, torch tensor), both f16."""
    return jnp.asarray(a).astype(jnp.float16), torch.from_numpy(a).to(F16)


def as32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels, in f16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "float16"])
@pytest.mark.parametrize("rows,d", [(7, 32), (64, 768), (300, 1000)])
def test_layer_norm_f16_matches_pallas(rows, d, param_dtype):
    """x in f16, gamma and beta in f32 or (as an f16 module holds them) in
    f16: the kernel reads them as they are, the Pallas kernel widens them
    to f32 first; widening f16 is exact."""
    rng = np.random.RandomState(rows + d)
    x = (rng.randn(rows, d) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    xj, xt = both(x)
    if param_dtype == "float16":
        (gj, gt), (bj, bt) = both(g), both(b)
    else:
        (gj, gt), (bj, bt) = ((jnp.asarray(a), torch.from_numpy(a))
                              for a in (g, b))
    want = jax_layer_norm(xj, gj, bj, eps=1e-12, interpret=True)
    ln.reset_counts()
    got = ln.layer_norm(xt, gt, bt, eps=1e-12)
    assert (ln.launches, ln.plain_calls) == (0, 1)
    assert got.dtype == F16 and str(want.dtype) == "float16"
    np.testing.assert_allclose(as32(got), as32(want), **TOL16)


def qkv(seed, b, h, lq, lk, d):
    rng = np.random.RandomState(seed)
    return [both(rng.randn(b, h, n, d).astype(np.float32))
            for n in (lq, lk, lk)]


FLASH = [(0, 1, 2, 32, 32, 64, False), (1, 1, 2, 40, 40, 64, True),
         (2, 1, 2, 16, 48, 64, True), (3, 2, 2, 32, 32, 128, True)]


@pytest.mark.parametrize("case", FLASH, ids=["d64", "d64_causal_unaligned",
                                             "d64_causal_lq_lt_lk",
                                             "d128_causal"])
def test_flash_f16_forward_dq_and_dkv_match_pallas(case):
    """The forward (P rounded to f16 before P V), dQ and dK/dV (dS and P
    rounded to f16 before the second products, as ``_dq_kernel`` and
    ``_dkv_kernel`` do) against the Pallas forward and ``jax.vjp`` of the
    Pallas module in interpret mode."""
    seed, b, h, lq, lk, d, causal = case
    (qj, qt), (kj, kt), (vj, vt) = qkv(seed, b, h, lq, lk, d)
    doj, dot = both(np.random.RandomState(seed + 100).randn(
        b, h, lq, d).astype(np.float32))
    out_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True),
        qj, kj, vj)
    grads_j = vjp(doj)
    fa.reset_counts()
    out, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    delta = (dot.float() * out.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(qt, kt, vt, dot, lse, delta,
                                   causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(qt, kt, vt, dot, lse, delta,
                                        causal=causal)
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == \
        (1, 1, 1)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == F16
    np.testing.assert_allclose(as32(out), as32(out_j), **TOL16)
    for name, g, gj in zip("qkv", (dq, dk, dv), grads_j):
        np.testing.assert_allclose(as32(g), as32(gj), err_msg=f"d{name}",
                                   **TOL16)


def test_flash_f16_backward_rounds_ds_as_pallas_does():
    """dK from dS rounded to f16 (the Pallas kernels' cast) is not the same
    math with dS kept in f32, and is the nearer of the two to jax.vjp of
    the Pallas module."""
    seed, b, h, lq, lk, d = 24, 1, 2, 48, 48, 64
    (qj, qt), (kj, kt), (vj, vt) = qkv(seed, b, h, lq, lk, d)
    doj, dot = both(np.random.RandomState(seed + 100).randn(
        b, h, lq, d).astype(np.float32))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=True, block_q=16, block_k=16, interpret=True),
        qj, kj, vj)
    dk_j = as32(vjp(doj)[1])
    out, lse = fa.flash_attention_ref(qt, kt, vt, causal=True)
    dk = as32(fa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                         causal=True)[1])
    delta = (dot.float() * out.float()).sum(-1)
    _, ds, acc = fa._p_and_ds(qt, kt, vt, dot, lse, delta, True, 1 / 8.0,
                              lk)
    dk_f32 = as32((ds.transpose(-1, -2) @ qt.to(acc)).to(F16))
    assert np.abs(dk - dk_f32).max() > 0
    assert (dk == dk_j).mean() > (dk_f32 == dk_j).mean()
    assert np.linalg.norm(dk - dk_j) < np.linalg.norm(dk_f32 - dk_j)


@pytest.mark.parametrize("act", ["relu", "relu6", None])
@pytest.mark.parametrize("c", [3, 16, 64])
def test_scale_shift_act_f16_matches_pallas(c, act):
    rng = np.random.RandomState(c + 1)
    x = (3.0 * rng.randn(37, c)).astype(np.float32)
    s = (0.5 + rng.rand(c)).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    xj, xt = both(x)
    want = jcbr.scale_shift_act(xj, jnp.asarray(s), jnp.asarray(b), act=act,
                                interpret=True)
    cbr.reset_counts()
    got = cbr.scale_shift_act(xt, torch.from_numpy(s), torch.from_numpy(b),
                              act)
    assert (cbr.ssa_launches, cbr.ssa_plain_calls) == (0, 1)
    assert got.dtype == F16
    np.testing.assert_allclose(as32(got), as32(want), **TOL16)


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("m,k,n", [(60, 64, 64), (60, 256, 64),
                                   (30, 64, 256), (30, 12, 20)])
def test_mm_epilogue_f16_matches_pallas(m, k, n, act):
    """The fused 1x1-conv GEMM in f16 (the wgmma kernel's route on the card
    where K and N are multiples of 8; the SIMT kernel's for 12 x 20)."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    s = (0.5 + rng.rand(n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    (xj, xt), (wj, wt) = both(x), both(w)
    want = jcbr._mm_epilogue(xj, wj, jnp.asarray(s), jnp.asarray(b), act,
                             True)
    cbr.reset_counts()
    got = cbr.mm_epilogue(xt, wt, torch.from_numpy(s), torch.from_numpy(b),
                          act)
    assert (cbr.mm_launches, cbr.mm_wgmma_launches, cbr.mm_plain_calls) \
        == (0, 0, 1)
    assert got.dtype == F16 and got.shape == (m, n)
    np.testing.assert_allclose(as32(got), as32(want)[:m], **TOL16)
    # the plan's split-K path gives the same function
    split = cbr.mm_splitk_ref(xt, wt, torch.from_numpy(s),
                              torch.from_numpy(b), act, 2)
    assert split.dtype == F16
    np.testing.assert_allclose(as32(split), as32(want)[:m], **TOL16)


def test_f16_overflow_is_inf_on_both_sides():
    """f16 tops out at 65504: a value past it is inf in the plain versions,
    as the Pallas kernels' cast makes it, never clamped, so that a dynamic
    loss scaler sees it."""
    x = np.full((8, 16), 300.0, np.float32)
    s = np.full(16, 300.0, np.float32)
    b = np.zeros(16, np.float32)
    xj, xt = both(x)
    want = jcbr.scale_shift_act(xj, jnp.asarray(s), jnp.asarray(b),
                                act=None, interpret=True)
    got = cbr.scale_shift_act(xt, torch.from_numpy(s), torch.from_numpy(b),
                              None)
    assert np.isposinf(as32(want)).all() and torch.isposinf(got).all()
    w = np.full((16, 16), 300.0, np.float32)
    wj, wt = both(w)
    want = jcbr._mm_epilogue(xj, wj, jnp.ones(16), jnp.zeros(16), None, True)
    got = cbr.mm_epilogue(xt, wt, torch.ones(16), torch.zeros(16), None)
    assert np.isposinf(as32(want)).all() and torch.isposinf(got).all()
    # a layer norm whose f32 gamma carries some normalised values past it
    g = np.full(16, 1e5, np.float32)
    xrj, xrt = both(np.random.RandomState(0).randn(8, 16).astype(np.float32))
    want = jax_layer_norm(xrj, jnp.asarray(g), jnp.zeros(16), interpret=True)
    got = ln.layer_norm(xrt, torch.from_numpy(g), torch.zeros(16))
    np.testing.assert_array_equal(np.isinf(as32(got)), np.isinf(as32(want)))
    assert np.isinf(as32(got)).any()


# ---------------------------------------------------------------------------
# the f16 routes, plans and dtype codes
# ---------------------------------------------------------------------------

def test_f16_takes_the_wgmma_route_and_the_bf16_plan():
    """f16 moves the bytes bf16 moves in every tile, so it takes bf16's
    route and plan at every ResNet-50 GEMM shape and bucket."""
    shapes = chip_smoke.bnrelu_gemm_shapes()
    for pix, k, n in shapes:
        assert cbr.mm_route(n, k, F16, True) == "wgmma"
        assert cbr.mm_route(n, k, F16, False) == "simt"
        for bucket in (1, 2, 4, 8, 16, 32):
            m = bucket * pix
            assert cbr.mm_plan(m, n, k, F16) == cbr.mm_plan(
                m, n, k, torch.bfloat16)
            _, split = cbr.mm_plan(m, n, k, F16)
            assert cbr.mm_ranges(k, split, F16) == cbr.mm_ranges(
                k, split, torch.bfloat16)
    assert cbr.mm_route(30, 12, F16, True) == "simt"
    assert cbr._simt_plan(100, 30, 70, F16) == cbr._simt_plan(
        100, 30, 70, torch.bfloat16)


def test_forced_plans_take_the_16_bit_tiles_in_f16():
    x, w = torch.zeros(4, 8, dtype=F16), torch.zeros(8, 16, dtype=F16)
    s = torch.ones(16)
    for tile in cbr.MM_WGMMA_TILES:
        got = cbr._mm_epilogue_with_plan(x, w, s, s, "relu", (tile, 2))
        assert got.dtype == F16 and got.shape == (4, 16)
    got = cbr._mm_epilogue_with_plan(x, w, s, s, "relu", (cbr.MM_TILE, 2),
                                     route="simt")
    assert got.dtype == F16


@pytest.mark.parametrize("mod", [ln, fa, cbr],
                         ids=["layer_norm", "flash_attention",
                              "conv_bn_relu"])
def test_each_wrapper_takes_float16_as_dtype_code_2(mod):
    """The Python side's code for f16 is the one every C entry reads:
    ``kFloat16 = 2`` in ``common.cuh``."""
    assert mod._DTYPES == {torch.float32: 0, torch.bfloat16: 1, F16: 2}
    common = (CSRC / "common.cuh").read_text()
    assert re.search(r"kFloat16\s*=\s*2", common)


@pytest.mark.parametrize("source,entries", [
    ("layer_norm.cu", 1), ("conv_bn_relu.cu", 3), ("mm_wgmma.cu", 1),
    ("flash_attention.cu", 1), ("flash_attention_bwd.cu", 1)])
def test_every_c_entry_dispatches_float16(source, entries):
    """Each C entry of the sources takes dtype code 2 and sends it to an
    __half instance (no f16 call falls through to cudaErrorInvalidValue)."""
    src = (CSRC / source).read_text()
    assert len(re.findall(r"kFloat16\)?\s*[:)]", src)) >= entries, source
    assert "<__half>" in src or "<__half," in src, source


def test_wgmma_signature_matches_the_c_prototype():
    """``mxt_mm_epilogue_wgmma`` took a dtype code beside its act: ctypes
    passes what ``_WGMMA_SIGNATURES`` declares, held to the prototype."""
    import ctypes
    src = (CSRC / "mm_wgmma.cu").read_text()
    proto = re.search(r'extern "C" int mxt_mm_epilogue_wgmma\(([^)]*)\)',
                      src)
    args = [a.strip() for a in proto.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in a else ctypes.c_int for a in args]
    assert [a.split()[-1] for a in args][9:11] == ["act", "dtype"]
    restype, argtypes = cbr._WGMMA_SIGNATURES["mxt_mm_epilogue_wgmma"]
    assert restype is ctypes.c_int and argtypes == want


# ---------------------------------------------------------------------------
# BERT and the LM in f16, against the JAX package's cast("float16")
# ---------------------------------------------------------------------------

def test_bert_f16_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    jnet = JaxBERT(**BERT)
    jnet.initialize(init=mx.init.Normal(0.02))
    tnet = load_jax_params(BERTModel(**BERT), jax_random(jnet, 4, 0.3))
    ids = bert_ids(5)
    with torch.inference_mode():
        truth = [as32(o) for o in tnet(torch.from_numpy(ids))]
    jnet.cast("float16")
    tnet.to(F16)
    seq_j, pooled_j = jnet(nd.array(ids, dtype="int32"))
    fa.reset_counts()
    ln.reset_counts()
    with torch.inference_mode():
        seq_t, pooled_t = tnet(torch.from_numpy(ids))
    assert (fa.plain_calls, ln.plain_calls) == (2, 5)
    assert seq_t.dtype == pooled_t.dtype == F16
    assert str(seq_j._data.dtype) == "float16"
    close("f16 sequence output", as32(seq_t), f32(seq_j), truth[0])
    close("f16 pooled output", as32(pooled_t), f32(pooled_j), truth[1])


def test_lm_f16_amp_step_matches_jax(monkeypatch):
    """One amp step in f16 on both sides: ``amp.init("float16")``, the
    module cast, Adam with f32 masters, a static loss scale of 2**10 and
    ``amp.scale_loss``; the loss and every scaled gradient against the JAX
    package's, both held against the port's f32 step times the scale."""
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    scale = 2.0 ** 10
    jnet = JaxLM(97, **LM)
    jnet.initialize(init=mx.init.Normal(0.02))
    tnet = load_jax_params(TransformerLM(97, **LM), jax_random(jnet, 6, 0.1))
    x = np.random.RandomState(7).randint(0, 97, (3, 24)).astype(np.int32)
    xj, xt = nd.array(x, dtype="int32"), torch.from_numpy(x)
    ref = copy.deepcopy(tnet)
    with autograd.record():
        t_loss = lm_loss(ref(xt), xt)
    autograd.backward(t_loss)
    truth = {n: p.grad * scale for n, p in ref.named_parameters()}

    jamp.init("float16")
    jnet.cast(jamp.target_dtype())
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"multi_precision": True})
    jamp.init_trainer(jtrainer, jamp.LossScaler(scale))
    with jautograd.record():
        jloss = jax_lm_loss(jnet(xj), xj)
        with jamp.scale_loss(jloss, jtrainer) as scaled:
            scaled.backward()
    try:
        amp.init("float16")
        tnet.to(getattr(torch, amp.target_dtype()))
        trainer = gluon.Trainer(tnet, "adam", {"multi_precision": True})
        amp.init_trainer(trainer, amp.LossScaler(scale))
        fa.reset_counts()
        ln.reset_counts()
        with autograd.record():
            loss = lm_loss(tnet(xt), xt)
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
    finally:
        amp.init()
        jamp.init()
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls,
            ln.plain_calls) == (2, 2, 2, 5)
    assert loss.dtype == F16 and str(jloss._data.dtype) == "float16"
    close("f16 per-token loss", as32(loss), f32(jloss), as32(t_loss))
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        assert p.grad.dtype == F16, name
        close(name, as32(p.grad), f32(jp[name].grad()), as32(truth[name]))


def test_frozen_f16_module_serves_f16_and_keeps_ids():
    """f16 serving is the module cast to f16 and frozen with
    compute_dtype=None (the JAX FrozenModel takes only f32 and bf16 compute
    dtypes, as the port's does): int32 ids pass as they are, the answers
    come back in f16, equal to the cast module's own forward."""
    jnet = JaxBERT(**BERT)
    jnet.initialize(init=mx.init.Normal(0.02))
    tnet = load_jax_params(BERTModel(**BERT), jax_random(jnet, 8, 0.3))
    half = copy.deepcopy(tnet).to(F16).eval()
    fm = FrozenModel(half, input_shape=(16,), dtype="int32",
                     batch_buckets=(1, 2, 4), ctx=cpu())
    ids = bert_ids(9)
    seq, pooled = fm.predict_batch(ids)
    assert seq.dtype == pooled.dtype == np.float16
    with torch.inference_mode():
        want = half(torch.from_numpy(ids))
    np.testing.assert_array_equal(seq, want[0].numpy())
    np.testing.assert_array_equal(pooled, want[1].numpy())
    with pytest.raises(ValueError, match="compute_dtype"):
        FrozenModel(tnet, input_shape=(16,), batch_buckets=(1,), ctx=cpu(),
                    compute_dtype="float16")
