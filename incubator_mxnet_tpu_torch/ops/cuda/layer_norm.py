"""LayerNorm forward over the last axis: the CUDA kernel of
``csrc/layer_norm.cu``, its wrapper, and the plain PyTorch version.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/layer_norm.py``. The wrapper
takes the kernel for a CUDA tensor and the plain version for a CPU tensor;
there is no other switch and no fallback. ``launches`` counts kernel
launches and ``plain_calls`` calls that took the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_ref", "launches", "plain_calls",
           "reset_counts", "MAX_WIDTH"]

launches = 0
plain_calls = 0

# the wide-row kernel stages one f32 row in shared memory (227 KB a block)
MAX_WIDTH = 56 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"mxt_layer_norm_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])}


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def layer_norm_ref(x, gamma, beta, eps=1e-5):
    """The plain version: f32 mean and biased variance over the last axis,
    normalize, f32 affine, cast back to x's dtype (``_ln_kernel``'s
    arithmetic)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of `x` with 1-D `gamma`/`beta` of its
    width. A CUDA `x` (f32 or bf16) launches the kernel on the current
    stream; a CPU `x` runs :func:`layer_norm_ref`."""
    global launches, plain_calls
    d = x.shape[-1]
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"layer_norm: gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} must be ({d},)")
    if x.device.type == "cpu":
        plain_calls += 1
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("layer_norm: x, gamma and beta must share a device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes widths 1..{MAX_WIDTH}, "
                         f"got {d}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous x")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"layer_norm kernel takes < 2**31 rows, got {rows}")
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.load("layer_norm", _SIGNATURES)
    rc = lib.mxt_layer_norm_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d,
        float(eps), _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
