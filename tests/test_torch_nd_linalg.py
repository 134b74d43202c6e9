"""The port's ``nd.linalg`` against the JAX package's, on the CPU: every
function on seeded inputs (symmetric positive definite matrices for the
Cholesky family and the eigensolver, triangular ones for the triangular
products and solves), batched, within 1e-5 relative (1e-5 absolute).

The factorizations with a sign freedom (``gelqf``'s rows of Q and
columns of L, ``syevd``'s eigenvectors) are held up to that sign: the
product of the factors must give the input back, and each factor must
equal the JAX package's with its sign chosen to match.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import cpu, nd

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.RandomState(7)
    a = rng.standard_normal((2, 4, 4)).astype(np.float32)
    spd = (a @ a.transpose(0, 2, 1) + 4 * np.eye(4)).astype(np.float32)
    low = np.tril(rng.standard_normal((2, 4, 4))).astype(np.float32)
    low += 3 * np.eye(4, dtype=np.float32)
    return {
        "a": a, "spd": spd, "low": low, "up": low.transpose(0, 2, 1).copy(),
        "b": rng.standard_normal((2, 4, 3)).astype(np.float32),
        "bt": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "c": rng.standard_normal((2, 4, 4)).astype(np.float32),
        "wide": rng.standard_normal((2, 3, 5)).astype(np.float32),
        "vec": rng.standard_normal((2, 3)).astype(np.float32),
        "packed": rng.standard_normal((2, 6)).astype(np.float32),
    }


CASES = {
    "gemm": lambda L, X: L.gemm(X["a"], X["b"], X["b"], alpha=0.5,
                                beta=2.0),
    "gemm_transposed": lambda L, X: L.gemm(X["a"], X["bt"], X["c"][:, :, :3],
                                           transpose_a=True,
                                           transpose_b=True),
    "gemm2": lambda L, X: L.gemm2(X["a"], X["b"], alpha=1.5),
    "gemm2_transpose_a": lambda L, X: L.gemm2(X["a"], X["c"],
                                              transpose_a=True),
    "potrf": lambda L, X: L.potrf(X["spd"]),
    "potrf_upper": lambda L, X: L.potrf(X["spd"], lower=False),
    "potri": lambda L, X: L.potri(L.potrf(X["spd"])),
    "potri_upper": lambda L, X: L.potri(L.potrf(X["spd"], lower=False),
                                        lower=False),
    "trmm": lambda L, X: L.trmm(X["low"], X["b"], alpha=2.0),
    "trmm_right_transpose": lambda L, X: L.trmm(X["low"], X["bt"],
                                                transpose=True,
                                                rightside=True),
    "trmm_upper": lambda L, X: L.trmm(X["up"], X["b"], lower=False),
    "trsm": lambda L, X: L.trsm(X["low"], X["b"], alpha=0.5),
    "trsm_transpose": lambda L, X: L.trsm(X["low"], X["b"], transpose=True),
    "trsm_right": lambda L, X: L.trsm(X["low"], X["bt"], rightside=True),
    "trsm_right_upper_transpose": lambda L, X: L.trsm(
        X["up"], X["bt"], rightside=True, lower=False, transpose=True),
    "sumlogdiag": lambda L, X: L.sumlogdiag(X["spd"]),
    "syrk": lambda L, X: L.syrk(X["wide"], alpha=0.5),
    "syrk_transpose": lambda L, X: L.syrk(X["wide"], transpose=True),
    "inverse": lambda L, X: L.inverse(X["spd"]),
    "det": lambda L, X: L.det(X["spd"] / 4),
    "slogdet": lambda L, X: L.slogdet(X["a"]),
    "makediag": lambda L, X: L.makediag(X["vec"]),
    "makediag_offset": lambda L, X: L.makediag(X["vec"], offset=-1),
    "extractdiag": lambda L, X: L.extractdiag(X["a"], offset=1),
    "maketrian": lambda L, X: L.maketrian(X["packed"]),
    "maketrian_upper": lambda L, X: L.maketrian(X["packed"], lower=False),
    "maketrian_offset": lambda L, X: L.maketrian(X["packed"], offset=1),
    "maketrian_negative_offset": lambda L, X: L.maketrian(X["packed"],
                                                          offset=-2),
    "extracttrian": lambda L, X: L.extracttrian(X["a"]),
    "extracttrian_upper_offset": lambda L, X: L.extracttrian(
        X["a"], offset=1),
    "extracttrian_lower_offset": lambda L, X: L.extracttrian(
        X["a"], offset=-1, lower=False),
}


def _run(fn, side):
    M, scope = (jnd, mx.cpu()) if side == "jax" else (nd, cpu())
    with scope:
        X = {k: M.array(v) for k, v in _inputs().items()}
        out = fn(M.linalg, X)
    outs = out if isinstance(out, tuple) else (out,)
    return [(o.asnumpy(), np.dtype(o.dtype)) for o in outs]


@pytest.mark.parametrize("case", list(CASES))
def test_linalg_matches_the_jax_package(case):
    got, want = _run(CASES[case], "port"), _run(CASES[case], "jax")
    assert len(got) == len(want)
    for (g, gdt), (w, wdt) in zip(got, want):
        assert gdt == wdt and g.shape == w.shape, (case, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=case, **TOL)


def _signed_like(got, want, axis):
    """`got` with each vector along `axis` negated where that brings it
    closer to `want`'s."""
    dot = (got * want).sum(axis=axis, keepdims=True)
    return got * np.where(dot < 0, -1.0, 1.0)


def test_gelqf_up_to_sign():
    (gl, gq), (wl, wq) = ([o for o, _ in _run(
        lambda L, X: L.gelqf(X["wide"]), side)] for side in ("port", "jax"))
    wide = _inputs()["wide"]
    np.testing.assert_allclose(gl @ gq, wide, **TOL)
    np.testing.assert_allclose(gq @ gq.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (2, 3, 3)), **TOL)
    assert np.allclose(np.triu(gl, 1), 0)
    np.testing.assert_allclose(_signed_like(gq, wq, -1), wq, **TOL)
    np.testing.assert_allclose(_signed_like(gl, wl, -2), wl, **TOL)


def test_syevd_up_to_sign():
    (gu, glam), (wu, wlam) = ([o for o, _ in _run(
        lambda L, X: L.syevd(X["spd"]), side)] for side in ("port", "jax"))
    spd = _inputs()["spd"]
    np.testing.assert_allclose(glam, wlam, **TOL)
    recon = gu.transpose(0, 2, 1) @ (glam[..., None] * gu)
    np.testing.assert_allclose(recon, spd, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_signed_like(gu, wu, -1), wu, rtol=1e-4,
                               atol=1e-4)


def test_linalg_is_differentiable():
    from incubator_mxnet_tpu import autograd as jautograd
    from incubator_mxnet_tpu_torch import autograd
    grads = []
    for M, A, scope in ((nd, autograd, cpu()), (jnd, jautograd, mx.cpu())):
        with scope:
            x = M.array(_inputs()["spd"])
            x.attach_grad()
            with A.record():
                y = M.linalg.sumlogdiag(M.linalg.potrf(x)).sum()
            y.backward()
            grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[0], grads[1], **TOL)
