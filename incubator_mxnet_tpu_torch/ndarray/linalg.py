"""Linear-algebra operator family on NDArrays (counterpart of
``incubator_mxnet_tpu/ndarray/linalg.py``; parity: python/mxnet/ndarray/
linalg.py, src/operator/tensor/la_op.cc).

Batched throughout (leading dims broadcast) and differentiable through
torch's autograd like every other op. The products (gemm, gemm2, trmm,
syrk) are ``torch.matmul``; the factorizations and solves are
``torch.linalg``'s. ``lower=True`` defaults match the reference.
"""
from __future__ import annotations

import math

import torch

from . import _apply, _as_nd

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "sumlogdiag",
           "syrk", "gelqf", "syevd", "inverse", "det", "slogdet",
           "makediag", "extractdiag", "maketrian", "extracttrian"]


def _mt(a, transpose):
    return torch.swapaxes(a, -1, -2) if transpose else a


def gemm(A, B, C, alpha=1.0, beta=1.0, transpose_a=False, transpose_b=False):
    """alpha * op(A) @ op(B) + beta * C."""
    C = _as_nd(C, A)
    return _apply(lambda a, b, c: alpha * _mt(a, transpose_a)
                  @ _mt(b, transpose_b) + beta * c,
                  [A, B, C], name="linalg_gemm")


def gemm2(A, B, alpha=1.0, transpose_a=False, transpose_b=False):
    """alpha * op(A) @ op(B)."""
    return _apply(lambda a, b: alpha * _mt(a, transpose_a)
                  @ _mt(b, transpose_b),
                  [A, B], name="linalg_gemm2")


def potrf(A, lower=True):
    """Cholesky factor (reference: positive-definite A = L @ L.T)."""
    return _apply(lambda a: torch.linalg.cholesky(a, upper=not lower), [A],
                  name="linalg_potrf")


def potri(A, lower=True):
    """Inverse from a Cholesky factor: (L @ L.T)^-1 given L."""
    def f(m):
        lt = m if lower else torch.swapaxes(m, -1, -2)
        eye = torch.eye(lt.shape[-1], dtype=lt.dtype,
                        device=lt.device).expand(lt.shape)
        linv = torch.linalg.solve_triangular(lt, eye, upper=False)
        return torch.swapaxes(linv, -1, -2) @ linv
    return _apply(f, [A], name="linalg_potri")


def _tri(a, lower):
    return torch.tril(a) if lower else torch.triu(a)


def trmm(A, B, alpha=1.0, transpose=False, rightside=False, lower=True):
    """Triangular matrix multiply: alpha * op(tri(A)) @ B (or B @ op)."""
    def f(a, b):
        tri = _mt(_tri(a, lower), transpose)
        return alpha * (b @ tri if rightside else tri @ b)
    return _apply(f, [A, B], name="linalg_trmm")


def trsm(A, B, alpha=1.0, transpose=False, rightside=False, lower=True):
    """Solve op(tri(A)) @ X = alpha * B (or X @ op(tri(A)) = alpha * B)."""
    def f(a, b):
        op = _mt(_tri(a, lower), transpose)
        return torch.linalg.solve_triangular(
            op, alpha * b, upper=lower == transpose, left=not rightside)
    return _apply(f, [A, B], name="linalg_trsm")


def sumlogdiag(A):
    """sum(log(diag(A))) per matrix (reference log-det helper)."""
    return _apply(lambda a: torch.log(torch.diagonal(a, 0, -2, -1)).sum(-1),
                  [A], name="linalg_sumlogdiag")


def syrk(A, alpha=1.0, transpose=False):
    """alpha * A @ A.T (or A.T @ A)."""
    def f(a):
        at = torch.swapaxes(a, -1, -2)
        return alpha * ((at @ a) if transpose else (a @ at))
    return _apply(f, [A], name="linalg_syrk")


def gelqf(A):
    """LQ factorization A = L @ Q with Q orthonormal rows (m <= n)."""
    def f(a):
        q, r = torch.linalg.qr(torch.swapaxes(a, -1, -2), mode="reduced")
        return torch.swapaxes(r, -1, -2), torch.swapaxes(q, -1, -2)
    return _apply(f, [A], n_out=2, name="linalg_gelqf")


def syevd(A):
    """Symmetric eigendecomposition: returns (U, lam) with
    A = U.T diag(lam) U (reference row-eigenvector convention)."""
    def f(a):
        lam, v = torch.linalg.eigh(a)
        return torch.swapaxes(v, -1, -2), lam
    return _apply(f, [A], n_out=2, name="linalg_syevd")


def inverse(A):
    return _apply(torch.linalg.inv, [A], name="linalg_inverse")


def det(A):
    return _apply(torch.linalg.det, [A], name="linalg_det")


def slogdet(A):
    return _apply(lambda a: tuple(torch.linalg.slogdet(a)), [A], n_out=2,
                  name="linalg_slogdet")


def makediag(A, offset=0):
    """Vector(s) -> diagonal matrix (reference linalg.makediag)."""
    return _apply(lambda a: torch.diag_embed(a, offset), [A],
                  name="linalg_makediag")


def extractdiag(A, offset=0):
    return _apply(lambda a: torch.diagonal(a, offset, -2, -1), [A],
                  name="linalg_extractdiag")


def _trian_indices(n, offset, lower, device):
    """Reference la_op semantics: the offset's sign picks the triangle
    (positive: the upper band, negative: the lower band); `lower` only
    breaks the tie at offset 0. Row-major order, as numpy's."""
    if offset > 0 or (offset == 0 and not lower):
        return torch.triu_indices(n, n, offset, device=device)
    return torch.tril_indices(n, n, offset, device=device)


def maketrian(A, offset=0, lower=True):
    """Packed vector(s) -> triangular matrix (reference maketrian)."""
    def f(a):
        k = a.shape[-1]
        n = (math.isqrt(8 * k + 1) - 1) // 2 + abs(offset)
        r, c = _trian_indices(n, offset, lower, a.device)
        out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype,
                          device=a.device)
        out[..., r, c] = a
        return out
    return _apply(f, [A], name="linalg_maketrian")


def extracttrian(A, offset=0, lower=True):
    """Triangular part of matrix(es) packed into a vector."""
    def f(a):
        r, c = _trian_indices(a.shape[-1], offset, lower, a.device)
        return a[..., r, c]
    return _apply(f, [A], name="linalg_extracttrian")
