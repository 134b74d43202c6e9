"""Flash-attention forward: the CUDA kernel of ``csrc/flash_attention.cu``,
its wrapper, and the plain PyTorch version.

Counterpart of the forward of ``incubator_mxnet_tpu/ops/pallas/
flash_attention.py``. The wrapper takes the kernel for CUDA tensors and the
plain version for CPU tensors; there is no other switch and no fallback.
``launches`` counts kernel launches and ``plain_calls`` calls that took the
plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "launches", "plain_calls", "reset_counts", "HEAD_DIMS"]

launches = 0
plain_calls = 0

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"mxt_flash_attention_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p])}


def reset_counts():
    global launches, plain_calls
    launches = 0
    plain_calls = 0


def _check(q, k, v, causal, kv_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, H, L, D) tensors")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if causal and lq > lk:
        raise ValueError("flash_attention: causal with more queries than keys "
                         "is undefined (use an explicit mask)")
    kv_len = lk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= lk:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {lk}]")
    return kv_len


def flash_attention_ref(q, k, v, *, causal=False, scale=None, kv_len=None):
    """The plain version, in f32: masked scores, exact softmax, ``(out in
    q's dtype, lse f32 (B, H, Lq))``. A row that sees no key gives 0 and an
    lse of -inf, as the kernel does."""
    kv_len = _check(q, k, v, causal, kv_len)
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(lk, device=q.device)
    mask = (col < kv_len)[None, :].expand(lq, lk)
    if causal:
        row = torch.arange(lq, device=q.device)[:, None]
        mask = mask & (col[None, :] <= row + (lk - lq))
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ v.float()) / torch.where(l == 0, torch.ones_like(l), l)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, causal=False, scale=None, kv_len=None):
    """Attention forward on (B, H, L, D) tensors: ``(out (B, H, Lq, D) in q's
    dtype, lse (B, H, Lq) f32)``. `scale` defaults to 1/sqrt(D); keys at or
    past `kv_len` (default Lk) are masked; `causal` masks bottom-right
    (row r sees keys c <= r + Lk - Lq).

    CUDA tensors (f32 or bf16, D in ``HEAD_DIMS``, unit stride on D) launch
    the kernel on the current stream; it reads through the given strides and
    writes `out` as a (B, H, Lq, D) view of a contiguous (B, Lq, H, D)
    buffer, so merging heads afterwards is free. CPU tensors run
    :func:`flash_attention_ref`."""
    global launches, plain_calls
    kv_len = _check(q, k, v, causal, kv_len)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        plain_calls += 1
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a unit stride on the "
                         "head dimension")
    if b * h >= 2 ** 31 or lq >= 2 ** 31 or lk >= 2 ** 31:
        raise ValueError("flash_attention kernel: shape too large")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, lq, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h == 0 or lq == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    rc = lib.mxt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, lq, lk, d, _DTYPES[q.dtype],
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        scale, int(bool(causal)), kv_len, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal=False, scale=None, kv_len=None):
    """:func:`flash_attention_fwd` without the lse: (B, H, Lq, D)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               kv_len=kv_len)[0]
