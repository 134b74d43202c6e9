"""LayerNorm over the last axis: the CUDA forward kernel of
``csrc/layer_norm.cu``, its wrapper, its plain PyTorch version, and the
``torch.autograd.Function`` that gives it a backward.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/layer_norm.py``: its
``_ln_fwd_impl`` kernel and its ``custom_vjp``. The forward wrapper takes
the kernel for a CUDA tensor and the plain version for a CPU tensor; there
is no other switch and no fallback. ``launches`` counts kernel launches and
``plain_calls`` calls that took the plain version. The backward is the
closed form of ``_ln_bwd`` in PyTorch ops on both devices: the JAX package
computes it in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_ref",
           "layer_norm_bwd", "LayerNormFunction", "launches", "plain_calls",
           "reset_counts", "MAX_WIDTH"]

launches = 0
plain_calls = 0

# the wide-row kernel stages one f32 row in shared memory (227 KB a block)
MAX_WIDTH = 56 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {"mxt_layer_norm_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _acc(dtype):
    """f32, or f64 for f64 inputs (so that gradcheck can hold the plain
    versions in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm_ref(x, gamma, beta, eps=1e-5):
    """The plain version: f32 mean and biased variance over the last axis,
    normalize, f32 affine, cast back to x's dtype (``_ln_kernel``'s
    arithmetic)."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.to(acc) + beta.to(acc)).to(x.dtype)


def _check(x, gamma, beta):
    d = x.shape[-1]
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"layer_norm: gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} must be ({d},)")


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm forward over the last axis of `x` with 1-D `gamma`/`beta`
    of its width. A CUDA `x` (f32, bf16 or f16) launches the kernel on the
    current stream, which reads f32, bf16 or f16 `gamma` and `beta` in their
    own dtype (others are cast to f32 first); a CPU `x` runs
    :func:`layer_norm_ref`. Not differentiable: see :func:`layer_norm`."""
    global launches, plain_calls
    _check(x, gamma, beta)
    d = x.shape[-1]
    if x.device.type == "cpu":
        plain_calls += 1
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("layer_norm: x, gamma and beta must share a device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes widths 1..{MAX_WIDTH}, "
                         f"got {d}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous x")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"layer_norm kernel takes < 2**31 rows, got {rows}")
    # the kernel reads f32, bf16 and f16 parameters as they are, so a
    # model's parameters in any of them reach it with nothing launched
    # before it
    g, b = ((p if p.dtype in _DTYPES else p.float()).contiguous()
            for p in (gamma, beta))
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.load("layer_norm", _SIGNATURES)
    rc = lib.mxt_layer_norm_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d,
        float(eps), _DTYPES[x.dtype], _DTYPES[g.dtype], _DTYPES[b.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y


def layer_norm_bwd(x, gamma, dy, eps=1e-5):
    """The closed form of ``_ln_bwd``: recompute the mean and rstd from the
    saved x in f32, then ``(dx in x's dtype, dgamma, dbeta in gamma's
    dtype)``, the parameter gradients summed over every leading axis."""
    d = x.shape[-1]
    acc = _acc(x.dtype)
    xf = x.reshape(-1, d).to(acc)
    g = dy.reshape(-1, d).to(acc)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dgamma = (g * xhat).sum(0).to(gamma.dtype)
    dbeta = g.sum(0).to(gamma.dtype)
    gg = g * gamma.to(acc)
    dx = (gg - gg.mean(-1, keepdim=True)
          - xhat * (gg * xhat).mean(-1, keepdim=True)) * rstd
    return dx.to(x.dtype).reshape(x.shape), dgamma, dbeta


class LayerNormFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the Pallas layer norm: the forward runs
    :func:`layer_norm_fwd` and saves x and gamma; the backward is
    :func:`layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        # autograd casts dbeta to beta's dtype where the two differ
        return (*layer_norm_bwd(x, gamma, dy, ctx.eps), None)


def layer_norm(x, gamma, beta, eps=1e-5):
    """Differentiable LayerNorm over the last axis of `x` with 1-D
    `gamma`/`beta` of its width: the kernel forward for a CUDA `x`, the
    plain version for a CPU `x`, and the closed-form backward on both."""
    return LayerNormFunction.apply(x, gamma, beta, eps)
