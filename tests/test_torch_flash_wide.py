"""Head dims above 256 (ROADMAP C5b): the port's attention against the JAX
package's Pallas kernels at D = 257, 320 and 512.

On the card the wide kernels (the forward's ``flash_fwd_wide_wgmma_kernel``
and ``flash_fwd_wide_tf32x3_kernel`` in ``csrc/flash_attention.cu``, dQ's
and dK/dV's in ``csrc/flash_attention_wide.cu``) take any multiple of 64
above 256; the differentiable entry point pads 257-319 up
to 320 (and so on) with zeros, keeping the true head dim's scale, and
slices the output and the gradients back, as the Pallas module pads D to
128 lanes. On the CPU the wrappers run their plain versions on the same
padded tensors; the Pallas kernels run in interpret mode, forward and
``jax.vjp``, on the same numpy inputs, through the module's ``_flash``
with a ``kv_len`` below the key count. A one-layer TransformerLM with two
heads of 512 is held against the JAX model under ``MXTPU_PALLAS=force``.
The CUDA instances themselves are held against the plain versions on the
card by ``chip_smoke.py`` (``flash_wide``, ``train_lm_d512_*``).
"""
import importlib
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.transformer_lm import TransformerLM as JaxLM
from incubator_mxnet_tpu.models.transformer_lm import lm_loss as jax_lm_loss
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_loss
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

from test_torch_flash_d256 import _TOL, _TORCH, _both, _f32
from test_torch_lm_d256 import _phases
from test_torch_transformer_lm import TOL, jax_params

BLOCK = 8
# the Pallas module itself (its package exports the entry function under
# the same name)
jax_flash_mod = importlib.import_module(
    "incubator_mxnet_tpu.ops.pallas.flash_attention")
jax_flash = jax_flash_mod.flash_attention


def _pallas(q, k, v, causal, kv_len):
    """The Pallas forward through ``_flash`` with the given kv_len (the
    public entry always passes Lk), on (B, H, L, D) with L a multiple of
    the block: (B, H, Lq, D)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    cfg = (1.0 / math.sqrt(d), causal, BLOCK, BLOCK, kv_len, lk - lq, True)
    out, _ = jax_flash_mod._flash(q.reshape(b * h, lq, d),
                                  k.reshape(b * h, lk, d),
                                  v.reshape(b * h, lk, d), cfg)
    return out.reshape(b, h, lq, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [257, 320, 512])
def test_attention_above_head_dim_256_matches_pallas(d, causal, dtype):
    """Forward and dQ, dK, dV through the Function at lq != lk with keys
    cut by kv_len, against the Pallas forward and ``jax.vjp`` in
    interpret mode; the plain versions are handed the padded head dim
    (257 runs at 320), each once."""
    rng = np.random.RandomState(d + causal)
    lq, lk, kv_len = 16, 24, 19
    q, k, v, do = (rng.randn(1, 2, n, d).astype(np.float32)
                   for n in (lq, lk, lk, lq))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(a, dtype) for a in (q, k, v, do))
    out_j, vjp = jax.vjp(lambda q, k, v: _pallas(q, k, v, causal, kv_len),
                         qj, kj, vj)
    grads_j = vjp(doj)

    seen = []
    real = fa.flash_attention_fwd

    def spy(q, *a, **kw):
        seen.append(q.shape[-1])
        return real(q, *a, **kw)
    fa.reset_counts()
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    try:
        fa.flash_attention_fwd = spy
        out = fa.flash_attention(*leaves, causal=causal, kv_len=kv_len)
    finally:
        fa.flash_attention_fwd = real
    out.backward(dot)
    assert seen == [fa.kernel_head_dim(d)] == [-(-d // 64) * 64]
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == (
        1, 1, 1)
    assert out.shape == qt.shape and out.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_f32(out), _f32(out_j), **_TOL[dtype])
    for name, leaf, g in zip("qkv", leaves, grads_j):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(_f32(leaf.grad), _f32(g),
                                   err_msg=f"d{name}", **_TOL[dtype])
    # keys at or past kv_len take no gradient
    assert not leaves[1].grad[:, :, kv_len:].any()
    assert not leaves[2].grad[:, :, kv_len:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_flash_kernel_name_above_256_is_the_wide_kernel(kind, dtype):
    """The traced name chip_smoke holds a launch at D > 256 to: the wide
    kernel of the dtype, credited to its wrapper's count. In f32 every
    kind is the split-TF32 wide kernel (flash_fwd_wide_tf32x3_kernel,
    flash_bwd_dq_wide_tf32x3_kernel, flash_bwd_dkv_wide_tf32x3_kernel); in
    bf16 and f16 every kind is the wgmma wide kernel
    (flash_fwd_wide_wgmma_kernel, flash_bwd_dq_wide_wgmma_kernel,
    flash_bwd_dkv_wide_wgmma_kernel), dQ's and dK/dV's in the wide
    namespace of csrc/flash_attention_wide.cu."""
    t = {"float32": "float", "bfloat16": "__nv_bfloat16",
         "float16": "__half"}[dtype]
    form = "wide_tf32x3_" if dtype == "float32" else "wide_wgmma_"
    for d in (320, 512, 1024):
        name = chip_smoke.flash_kernel_name(kind, dtype, d)
        assert name == f"{kind}_{form}kernel<{t}"
    kinds = {"flash_fwd": "flash_attention", "flash_bwd_dq": "flash_bwd_dq",
             "flash_bwd_dkv": "flash_bwd_dkv"}
    where = "" if kind == "flash_fwd" else "wide::"
    traced = f"void mxt::(anonymous namespace)::{where}{name}>(...)"
    assert chip_smoke._kernel_kind(traced) == kinds[kind]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_no_launch_above_256_is_held_to_an_fma_wide_kernel(kind, dtype):
    """No dtype and no head dim above 256 names a bare `<kind>_wide_kernel<`
    (the FMA kernels that 16-bit dQ and dK/dV ran before their wgmma
    redesign, and every dtype's forward before its own); such a traced
    name still counts as its kind, so that hold_routes sees it and fails."""
    for d in (257, 320, 384, 512, 1024, 2048):
        name = chip_smoke.flash_kernel_name(kind, dtype, d)
        assert f"{kind}_wide_kernel<" not in name
    fma = f"void mxt::(anonymous namespace)::wide::{kind}_wide_kernel<__half>"
    assert chip_smoke._kernel_kind(fma) == {
        "flash_fwd": "flash_attention"}.get(kind, kind)


def test_wide_cases_put_a_head_on_every_remainder_of_4():
    """C11 above 256: the 16-bit dK/dV kernel reads lse and delta in TMA
    boxes from the multiple of 4 at or below bh * lq, so wide_cases() holds
    a case whose lq is no multiple of 4, with heads enough that bh * lq
    falls on every remainder mod 4: d320_l129_causal (two tiles and a
    ragged row)."""
    cases = {c[0]: c[1:] for c in chip_smoke.wide_cases()}
    assert cases["d320_l129_causal"] == (1, 4, 129, 129, 320, True, "bhld",
                                         None)
    odd = [(b, h, lq) for b, h, lq, *_ in cases.values() if lq % 4]
    assert odd
    assert any({(bh * lq) % 4 for bh in range(b * h)} == {0, 1, 2, 3}
               for b, h, lq in odd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_grads_at_d320_on_129_rows_match_pallas_kernels(dtype):
    """The plain dQ, dK and dV that the card holds
    flash_bwd_dq_wide_wgmma_kernel and flash_bwd_dkv_wide_wgmma_kernel to,
    at chip_smoke's d320_l129_causal (B 1, H 4, L 129, D 320, causal: two
    64-row tiles and a ragged row), against ``_dq_kernel`` and
    ``_dkv_kernel`` through ``jax.vjp`` in interpret mode. P is rounded to
    the input dtype before P^T dO and dS before dS K and dS^T Q on both
    sides."""
    rng = np.random.RandomState(129)
    b, h, n, d = 1, 4, 129, 320
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32)
                   for _ in range(4))
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _both(a, dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=True, block_q=64, block_k=64, interpret=True),
        qj, kj, vj)
    grads_j = vjp(doj)
    out, lse = fa.flash_attention_ref(qt, kt, vt, causal=True)
    delta = fa._delta(dot, out)
    fa.reset_counts()
    args = (qt, kt, vt, dot, lse, delta)
    dq = fa.flash_attention_bwd_dq(*args, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=True)
    assert (fa.dq_plain_calls, fa.dkv_plain_calls, fa.dq_launches,
            fa.dkv_launches) == (1, 1, 0, 0)
    assert torch.equal(dq, fa.flash_attention_bwd_dq_ref(*args, causal=True))
    for got, want in zip((dk, dv),
                         fa.flash_attention_bwd_dkv_ref(*args, causal=True)):
        assert torch.equal(got, want)
    # the ragged row sees every key up to its own: its dQ is not zero
    assert bool((dq[:, :, 128:].float().abs().sum(-1) > 0).all())
    for name, got, want in zip("qkv", (dq, dk, dv), grads_j):
        assert got.shape == (b, h, n, d) and got.dtype == _TORCH[dtype]
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   err_msg=f"d{name}", **_TOL[dtype])


VOCAB = 97
CFG = dict(num_layers=1, units=1024, hidden_size=64, num_heads=2,
           max_length=32)


def test_lm_with_heads_of_512_matches_jax(monkeypatch):
    """A one-layer TransformerLM with two heads of 512: logits, loss and
    every gradient against the JAX model with its Pallas kernels in
    interpret mode; one flash forward, dQ and dK/dV, on the plain route,
    at D = 512."""
    monkeypatch.setenv("MXTPU_PALLAS", "force")
    assert fa.kernel_head_dim(CFG["units"] // CFG["num_heads"]) == 512
    jnet = JaxLM(VOCAB, **CFG)
    arrays = jax_params(jnet, 0, 0.05)
    tnet = load_jax_params(TransformerLM(VOCAB, **CFG), arrays)
    x = np.random.RandomState(1).randint(0, VOCAB, (2, 16)).astype(np.int32)
    xj, xt = nd.array(x, dtype="int32"), torch.from_numpy(x)
    with jautograd.record():
        jlogits = jnet(xj)
        jloss = jax_lm_loss(jlogits, xj)
    jloss.backward()
    fa.reset_counts()
    with autograd.record():
        tlogits = tnet(xt)
        tloss = lm_loss(tlogits, xt)
    autograd.backward(tloss)
    assert (fa.plain_calls, fa.dq_plain_calls, fa.dkv_plain_calls) == (
        1, 1, 1)
    np.testing.assert_allclose(_f32(tlogits), _f32(jlogits), **TOL)
    np.testing.assert_allclose(_f32(tloss), _f32(jloss), **TOL)
    jp = jnet._collect_params_with_prefix()
    tgrads = {n: p.grad for n, p in tnet.named_parameters()}
    assert sorted(tgrads) == sorted(jp)
    for name, g in tgrads.items():
        want = _f32(jp[name].grad())
        np.testing.assert_allclose(
            _f32(g), want, rtol=1e-4,
            atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=name)


def test_the_d512_phases_train_heads_of_512_in_each_dtype():
    """chip_smoke's train_lm_d512_bf16 and train_lm_d512_f32 run
    train_lm_fused at LM_D512: LM_D256's width and FFN with 4 heads of 512
    and 2 layers; the flash_wide cases cover the path's shape."""
    cfg = chip_smoke.LM_D512
    assert cfg == dict(chip_smoke.LM_D256, num_heads=4, num_layers=2)
    assert fa.kernel_head_dim(cfg["units"] // cfg["num_heads"]) == 512
    phases = {p[0]: p for p in _phases()}
    for dtype, label in (("bfloat16", "train_lm_d512_bf16"),
                         ("float32", "train_lm_d512_f32")):
        _, fn, kw, star, _ = phases[label]
        assert fn == "train_lm_fused"
        assert kw == {"dtype": dtype, "label": label}
        assert star == ["LM_D512"]
    b, s = chip_smoke.LM["batch"], chip_smoke.LM["seq"]
    shapes = {c[0]: c[1:7] for c in chip_smoke.wide_cases()}
    assert shapes["lm_d512_b8_l512_causal"] == (b, 4, s, s, 512, True)
    assert {"autograd_api", "flash_wide"} <= set(phases)
