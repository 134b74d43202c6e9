"""Port kernels against the Pallas kernels of the JAX package.

On the CPU the port's wrappers run their plain versions (a CUDA kernel has
no interpret mode); the Pallas kernels run in interpret mode with small
blocks, as tests/test_pallas.py runs them. The same numpy inputs go to both.
The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_flash
from incubator_mxnet_tpu.ops.pallas import layer_norm as jax_layer_norm
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as ln

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(a, dtype):
    """One numpy array as (jax array, torch tensor) of `dtype`; both round
    f32 -> bf16 to nearest even, so the inputs are the same values."""
    return (jnp.asarray(a).astype(_JAX[dtype]),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("d", [32, 768])
@pytest.mark.parametrize("rows", [7, 64, 300])
def test_layer_norm_matches_pallas(rows, d, dtype, tol):
    rng = np.random.RandomState(rows + d)
    x = (rng.randn(rows, d) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    xj, xt = _both(x, dtype)
    ref = jax_layer_norm(xj, jnp.asarray(g), jnp.asarray(b), eps=1e-12,
                         interpret=True)
    out = ln.layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b),
                        eps=1e-12)
    assert out.dtype == _TORCH[dtype] and out.shape == xt.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


def test_layer_norm_keeps_leading_dims_and_counts_plain_calls():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16).astype(np.float32)
    g, b = np.ones(16, np.float32), np.zeros(16, np.float32)
    ln.reset_counts()
    out = ln.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b))
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                         interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (ln.launches, ln.plain_calls) == (0, 1)


def test_layer_norm_raises_instead_of_falling_back():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ln.layer_norm(x, torch.ones(8, device="meta"),
                      torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="gamma"):
        ln.layer_norm(torch.zeros(4, 8), torch.ones(7), torch.zeros(8))


@pytest.mark.parametrize("x_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 3e-2)])
@pytest.mark.parametrize("rows,d", [(7, 32), (300, 768)])
def test_layer_norm_with_bf16_gamma_and_beta_matches_pallas(rows, d, x_dtype,
                                                            tol):
    """gamma and beta as a bf16 model holds them (under amp or
    compute_dtype="bfloat16"): the kernel reads them as they are, and the
    Pallas kernel casts them to f32 first; widening bf16 is exact, so the
    two agree to x's dtype (f32 1e-5, bf16 one unit, 3e-2)."""
    rng = np.random.RandomState(rows + d + 1)
    x = (rng.randn(rows, d) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    xj, xt = _both(x, x_dtype)
    (gj, gt), (bj, bt) = _both(g, "bfloat16"), _both(b, "bfloat16")
    ref = jax_layer_norm(xj, gj, bj, eps=1e-12, interpret=True)
    out = ln.layer_norm(xt, gt, bt, eps=1e-12)
    assert out.dtype == _TORCH[x_dtype] and out.shape == xt.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


def test_layer_norm_signature_matches_the_c_prototype():
    """ctypes passes what ``_SIGNATURES`` declares, with no check against
    the C function: a pointer declared as an int would be cut to 32 bits,
    and a missing argument read as garbage, on the card only. So the
    declaration is held to the prototype of ``csrc/layer_norm.cu``."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(ln.__file__).parent / "csrc" / "layer_norm.cu").read_text()
    proto = re.search(r'extern "C" (\w+) mxt_layer_norm_fwd\(([^)]*)\)',
                      src)
    assert proto, "no extern \"C\" mxt_layer_norm_fwd in layer_norm.cu"
    c_types = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in arg else
            c_types[arg.split()[-2] if len(arg.split()) > 1 else arg]
            for arg in (a.strip() for a in proto.group(2).split(","))]
    restype, argtypes = ln._SIGNATURES["mxt_layer_norm_fwd"]
    assert restype is c_types[proto.group(1)]
    assert len(argtypes) == len(want) == 12
    assert argtypes == want


def test_layer_norm_cases_cover_the_main_paths():
    """chip_smoke's layer-norm cases hold the kernel at every row count the
    main paths give it at D = 768 (GPT-2's generate; BERT's buckets 1, 8,
    16 and 32, the last also a GPT-2 training step), in both dtypes, and
    reach the block kernel through a width of no whole 16-byte vectors."""
    import chip_smoke
    cases = chip_smoke.layer_norm_cases()
    names = [c[0] for c in cases]
    assert len(set(zip(names, (c[3] for c in cases)))) == len(cases)
    at_768 = {(rows, dt) for _, rows, d, dt in cases if d == 768}
    assert at_768 >= {(rows, dt) for rows in (8, 128, 1024, 2048, 4096)
                      for dt in ("float32", "bfloat16")}
    assert any(d % 8 for _, _, d, dt in cases if dt == "bfloat16")
    assert any(d % 4 for _, _, d, dt in cases if dt == "float32")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, b, h, lq, lk, d, dtype="float32"):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


def _compare_flash(seed, b, h, lq, lk, d, causal, dtype="float32", tol=2e-5):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, b, h, lq, lk, d, dtype)
    ref = jax_flash(qj, kj, vj, causal=causal, block_q=16, block_k=16,
                    interpret=True)
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == _TORCH[dtype] and out.shape == (b, h, lq, d)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d", [(32, 32, 16), (48, 80, 32),
                                     (160, 200, 16)])
def test_flash_forward_matches_pallas(causal, lq, lk, d):
    # 160 queries against 200 keys, at B = 1: ragged key blocks and a causal
    # offset of 40, which is no multiple of a block
    _compare_flash(0, 1 if lq == 160 else 2, 2, lq, lk, d, causal)


@pytest.mark.parametrize("kv_len", [0, 77])
def test_flash_forward_with_kv_len_matches_pallas_on_cut_keys(kv_len):
    """The JAX entry point takes no kv_len: keys at or past kv_len are
    masked, which is attention over K and V cut to their first kv_len keys
    (the Pallas kernel in interpret mode). With kv_len = 0 no row sees a
    key: O is 0 and the lse -inf."""
    import jax
    (qj, qt), (kj, kt), (vj, vt) = _qkv(15, 1, 2, 128, 128, 16)
    fa.reset_counts()
    out, lse = fa.flash_attention_fwd(qt, kt, vt, kv_len=kv_len)
    assert (fa.launches, fa.plain_calls) == (0, 1)
    if kv_len == 0:
        assert torch.count_nonzero(out) == 0
        assert torch.isneginf(lse).all()
        return
    kj, vj = kj[:, :, :kv_len], vj[:, :, :kv_len]
    ref = jax_flash(qj, kj, vj, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, kj) / 4.0     # scale 1/sqrt(16)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-5, atol=1e-5)


def test_flash_causal_cross_length_matches_pallas():
    # bottom-right causal with lq < lk: row r sees cols <= r + (lk - lq)
    _compare_flash(7, 1, 2, 16, 48, 8, causal=True)


def test_flash_decode_step_matches_pallas():
    _compare_flash(8, 2, 2, 1, 33, 8, causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_unaligned_lengths_match_pallas(causal):
    _compare_flash(2, 1, 1, 37, 37, 8, causal)
    _compare_flash(3, 1, 1, 23, 37, 8, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_head_dim_64_matches_pallas(causal):
    _compare_flash(4, 1, 2, 32, 32, 64, causal)


def test_flash_bf16_matches_pallas():
    _compare_flash(3, 1, 2, 32, 32, 16, False, dtype="bfloat16", tol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ref_lse_is_logsumexp_of_scores(causal):
    (_, q), (_, k), (_, v) = _qkv(5, 2, 3, 20, 29, 16)
    scale = 0.3
    out, lse = fa.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                      kv_len=25)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = torch.arange(29)[None, :] < 25
    if causal:
        keep = keep & torch.ones(20, 29, dtype=torch.bool).tril(29 - 20)
    s = s.masked_fill(~keep, float("-inf"))
    assert lse.shape == (2, 3, 20) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), (torch.softmax(s, -1) @ v).numpy(), rtol=2e-5,
        atol=2e-5)


def test_flash_fully_masked_row_gives_zero():
    (_, q), (_, k), (_, v) = _qkv(6, 1, 1, 4, 8, 16)
    out, lse = fa.flash_attention_ref(q, k, v, kv_len=0)
    assert torch.count_nonzero(out) == 0
    assert torch.isneginf(lse).all()


def test_flash_causal_more_queries_than_keys_raises():
    (_, q), (_, k), (_, v) = _qkv(9, 1, 1, 8, 4, 16)
    with pytest.raises(ValueError, match="more queries than keys"):
        fa.flash_attention(q, k, v, causal=True)


def test_kernel_build_names_and_missing_compiler(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    libs = {n: _build._target(n) for n in _build.SOURCES}
    assert libs == {n: _build._target(n) for n in _build.SOURCES}  # stable
    assert all(p.name.startswith(n + "-") and p.suffix == ".so"
               for n, p in libs.items())
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_flash_counts_plain_calls_and_raises_instead_of_falling_back():
    (_, q), (_, k), (_, v) = _qkv(10, 1, 2, 8, 8, 16)
    fa.reset_counts()
    fa.flash_attention(q, k, v)
    assert (fa.launches, fa.plain_calls) == (0, 1)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(*meta)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q, k[:, :1], v)
    assert (fa.launches, fa.plain_calls) == (0, 1)


# ---------------------------------------------------------------------------
# flash attention backward and the autograd Functions
# ---------------------------------------------------------------------------

def _compare_flash_bwd(seed, b, h, lq, lk, d, causal, dtype="float32",
                       tol=2e-5, block=16):
    """flash_attention_bwd_ref (the explicit math of `_bwd`) against jax.vjp
    of the Pallas flash attention in interpret mode, on the same q, k, v and
    dO. In f32 both compute in f32 and sum in other orders: 2e-5. In bf16
    both round P and dS to bf16 before the second products and the
    gradients once at the end, from f32 sums in other orders: `tol` is
    3e-2, the bf16 forward's, a few bf16 units at these magnitudes."""
    import jax
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, b, h, lq, lk, d, dtype)
    doj, dot = _both(np.random.RandomState(seed + 100).randn(
        b, h, lq, d).astype(np.float32), dtype)
    out_j, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=block, block_k=block,
        interpret=True), qj, kj, vj)
    grads_j = vjp(doj)
    out, lse = fa.flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(out_j), rtol=tol, atol=tol)
    fa.reset_counts()
    grads = fa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                       causal=causal)
    for name, g, gj in zip("qkv", grads, grads_j):
        assert g.shape == gj.shape and g.dtype == _TORCH[dtype], name
        np.testing.assert_allclose(_f32(g), _f32(gj), rtol=tol, atol=tol,
                                   err_msg=f"d{name}")
    # the Function's backward (the wrappers' CPU route) is the same function
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    fa.flash_attention(*leaves, causal=causal).backward(dot)
    assert (fa.dq_plain_calls, fa.dkv_plain_calls) == (1, 1)
    assert (fa.dq_launches, fa.dkv_launches) == (0, 0)
    for name, leaf, g in zip("qkv", leaves, grads):
        np.testing.assert_allclose(_f32(leaf.grad), _f32(g), rtol=1e-6,
                                   atol=1e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [
    (0, 2, 2, 32, 32, 16, False),
    (1, 2, 2, 32, 32, 16, True),
    (2, 1, 2, 16, 48, 16, True),       # lq < lk, bottom-right causal
    (3, 1, 1, 100, 100, 16, False),    # unaligned L
    (4, 1, 1, 100, 100, 16, True),
    (5, 1, 2, 32, 32, 64, True),       # D = 64, the LM's head dim
    (6, 1, 1, 32, 32, 128, False),     # D = 128
    # bf16, at the LM's head dim: the path the wgmma kernels take on the
    # card, whose plain version rounds P and dS as the Pallas kernels do
    (20, 1, 2, 32, 32, 64, False, "bfloat16", 3e-2),
    (21, 1, 2, 32, 32, 64, True, "bfloat16", 3e-2),
    (22, 1, 2, 40, 40, 64, True, "bfloat16", 3e-2),     # unaligned L
    (23, 1, 2, 16, 48, 64, True, "bfloat16", 3e-2),     # lq < lk
], ids=["noncausal", "causal", "causal_lq_lt_lk", "unaligned100",
        "unaligned100_causal", "d64_causal", "d128", "bf16_d64_noncausal",
        "bf16_d64_causal", "bf16_d64_unaligned40_causal",
        "bf16_d64_causal_lq_lt_lk"])
def test_flash_backward_matches_pallas_vjp(case):
    _compare_flash_bwd(*case)


def test_flash_bf16_backward_rounds_p_and_ds_as_pallas_does():
    """The Pallas kernels feed their second products in the input dtype:
    dS K with dS in bf16, P^T dO with P in bf16, dS^T Q with dS in bf16
    (`_dq_kernel`, `_dkv_kernel`). The plain backward does the same, so
    its bf16 dK differs from the same math with P and dS kept in f32, and
    is closer to jax.vjp of the Pallas module than that math is."""
    import jax
    seed, b, h, lq, lk, d = 24, 1, 2, 48, 48, 64
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, b, h, lq, lk, d, "bfloat16")
    doj, dot = _both(np.random.RandomState(seed + 100).randn(
        b, h, lq, d).astype(np.float32), "bfloat16")
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=True, block_q=16, block_k=16, interpret=True),
        qj, kj, vj)
    dk_j = _f32(vjp(doj)[1])
    out, lse = fa.flash_attention_ref(qt, kt, vt, causal=True)
    dk = _f32(fa.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                         causal=True)[1])
    # the same math with P and dS left in f32, dK rounded once at the end
    delta = (dot.float() * out.float()).sum(-1)
    _, ds, acc = fa._p_and_ds(qt, kt, vt, dot, lse, delta, True, 1 / 8.0,
                              lk)
    dk_f32 = _f32((ds.transpose(-1, -2) @ qt.to(acc)).to(torch.bfloat16))
    assert np.abs(dk - dk_f32).max() > 0
    # the rounding sits where the Pallas kernels' does: more of dK's
    # elements agree bit for bit, and it is closer in norm
    assert (dk == dk_j).mean() > (dk_f32 == dk_j).mean()
    assert np.linalg.norm(dk - dk_j) < np.linalg.norm(dk_f32 - dk_j)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [0, 20])
def test_flash_backward_with_kv_len_matches_autograd_of_plain(causal, kv_len):
    """The JAX entry point has no kv_len: hold the Function against autograd
    through flash_attention_ref. kv_len=0 leaves every row without a key:
    dQ, dK and dV must be 0, with no NaN from the lse of -inf."""
    (_, q), (_, k), (_, v) = _qkv(11, 2, 2, 24, 29, 16)
    do = torch.from_numpy(np.random.RandomState(12).randn(
        2, 2, 24, 16).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*a, causal=causal, scale=0.3, kv_len=kv_len)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = fa.flash_attention_ref(*b, causal=causal, scale=0.3,
                                    kv_len=kv_len)
    ref.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for name, x, y in zip("qkv", a, b):
        assert torch.isfinite(x.grad).all(), name
        # the same f32 math reassociated: 2e-5
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   rtol=2e-5, atol=2e-5, err_msg=f"d{name}")
    if kv_len == 0:
        assert all(torch.count_nonzero(x.grad) == 0 for x in a)
    else:
        assert torch.count_nonzero(a[1].grad[:, :, kv_len:]) == 0
        assert torch.count_nonzero(a[2].grad[:, :, kv_len:]) == 0


def test_flash_backward_kernels_split_and_raise_instead_of_falling_back():
    (_, q), (_, k), (_, v) = _qkv(13, 1, 2, 8, 8, 16)
    out, lse = fa.flash_attention_ref(q, k, v, causal=True)
    do = torch.ones_like(out)
    delta = (do * out).sum(-1)
    fa.reset_counts()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for g, r in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6, atol=1e-6)
    assert (fa.dq_plain_calls, fa.dkv_plain_calls) == (1, 1)
    meta = [t.to("meta") for t in (q, k, v, do, lse, delta)]
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_dq(*meta)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_dkv(*meta)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_bwd_dq(q, k, v, do[:, :, :4], lse, delta)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse[:, :1], delta)
    assert (fa.dq_launches, fa.dkv_launches) == (0, 0)
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    assert "flash_attention_bwd" in _build.SOURCES


def test_flash_backward_copies_only_inputs_whose_rows_are_off_16_bytes():
    """The backward kernels stage rows with 16-byte copies: the QKV views
    of one projection go in as they are, a view off 16 bytes as a copy."""
    proj = torch.zeros(2, 10, 3 * 4 * 64)
    for t in proj.chunk(3, dim=-1):
        view = t.reshape(2, 10, 4, 64).transpose(1, 2)
        assert fa._rows16(view) is view
    bf16 = proj.to(torch.bfloat16).chunk(3, dim=-1)[1].reshape(
        2, 10, 4, 64).transpose(1, 2)                 # 128-byte rows
    assert fa._rows16(bf16) is bf16
    shifted = torch.arange(1 + 2 * 4 * 10 * 64.0)[1:].view(2, 4, 10, 64)
    wide = torch.randn(2, 4, 10, 65)[..., :64]      # rows 65 floats apart
    for t in (shifted, wide):
        c = fa._rows16(t)
        assert c is not t and c.data_ptr() % 16 == 0 and torch.equal(c, t)
        assert all(s * 4 % 16 == 0 for s in c.stride()[:3])


def test_flash_bf16_copies_only_inputs_tma_cannot_read():
    """The bf16 forward reads through TMA tensor maps, which take strides
    that are multiples of 16 bytes and none that is zero: an expanded
    (broadcast) bf16 tensor goes in as a contiguous copy, f32 as it is."""
    base = torch.zeros(2, 1, 10, 64)
    for dtype in (torch.float32, torch.bfloat16):
        shared = base.to(dtype).expand(2, 4, 10, 64)     # head stride 0
        c = fa._rows16(shared)
        if dtype == torch.float32:
            assert c is shared
        else:
            assert c is not shared and c.is_contiguous()
            assert torch.equal(c, shared)
            assert all(fa._strides(c))


def test_flash_function_passes_gradcheck_in_float64():
    rng = np.random.RandomState(14)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 6, 4)).requires_grad_()
               for _ in range(3))
    for causal, kv_len in ((False, None), (True, None), (True, 5)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                               kv_len=kv_len), (q, k, v))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_layer_norm_backward_matches_pallas_vjp(dtype, tol):
    """The closed-form backward against jax.vjp of the Pallas layer norm
    (whose VJP is `_ln_bwd`): f32 to reassociation (2e-5), bf16 to one bf16
    ulp of dx (3e-2)."""
    import jax
    rng = np.random.RandomState(15)
    x = (rng.randn(2, 7, 48) * 2.0 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(48)).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    dy = rng.randn(2, 7, 48).astype(np.float32)
    xj, xt = _both(x, dtype)
    dyj, dyt = _both(dy, dtype)
    _, vjp = jax.vjp(lambda x, g, b: jax_layer_norm(x, g, b, eps=1e-5,
                                                    interpret=True),
                     xj, jnp.asarray(g), jnp.asarray(b))
    ref = vjp(dyj)
    leaves = [xt.clone().requires_grad_(),
              torch.from_numpy(g).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    y = ln.layer_norm(*leaves, eps=1e-5)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    y.backward(dyt)
    for name, leaf, r in zip(("dx", "dgamma", "dbeta"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(_f32(leaf.grad), _f32(r), rtol=tol,
                                   atol=tol * (10 if name != "dx" else 1),
                                   err_msg=name)


def test_layer_norm_function_passes_gradcheck_and_matches_plain_autograd():
    rng = np.random.RandomState(16)
    x, g, b = (torch.from_numpy(a).requires_grad_() for a in (
        rng.randn(3, 5, 6), 1 + 0.1 * rng.randn(6), rng.randn(6)))
    assert torch.autograd.gradcheck(
        lambda x, g, b: ln.layer_norm(x, g, b, 1e-5), (x, g, b))
    xf, gf, bf = (t.detach().float().requires_grad_() for t in (x, g, b))
    xp, gp, bp = (t.detach().float().requires_grad_() for t in (x, g, b))
    dy = torch.from_numpy(rng.randn(3, 5, 6).astype(np.float32))
    ln.layer_norm(xf, gf, bf, 1e-5).backward(dy)
    ln.layer_norm_ref(xp, gp, bp, 1e-5).backward(dy)
    for a, r in ((xf, xp), (gf, gp), (bf, bp)):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_raw_ops_route_layer_norm_and_attention_through_the_functions():
    from incubator_mxnet_tpu_torch import ops
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(2, 5, 32).astype(np.float32))
    x.requires_grad_()
    y = ops.layer_norm(x, torch.ones(32), torch.zeros(32))
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    fa.reset_counts()
    q, k, v = (x * s for s in (1.0, 0.5, 2.0))
    out = ops.multihead_attention(q, k, v, 2, causal=True)
    out.sum().backward()
    assert fa.plain_calls == 1
    assert (fa.dq_plain_calls, fa.dkv_plain_calls) == (1, 1)
    assert torch.isfinite(x.grad).all()
