"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (dQ and dK/dV), their wrappers, their
plain PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/flash_attention.py``: its
``_fwd``, the two kernels of its ``_bwd`` and its ``custom_vjp``. Each
wrapper takes its kernel for CUDA tensors and its plain version for CPU
tensors; there is no other switch and no fallback. Each kernel has its own
counts: ``launches``/``plain_calls`` (forward), ``dq_launches``/
``dq_plain_calls`` and ``dkv_launches``/``dkv_plain_calls`` (backward).

:func:`flash_attention` is the differentiable entry point: it pads a head
dim the kernels do not take (``HEAD_DIMS``) with zeros, as the Pallas
module pads D to 128 lanes; its backward computes delta = rowsum(dO * O)
with a PyTorch op, as ``_bwd`` does in XLA, then runs the two backward
kernels (their plain versions on the CPU).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_ref",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ref",
           "FlashAttentionFunction", "launches", "plain_calls",
           "dq_launches", "dq_plain_calls", "dkv_launches", "dkv_plain_calls",
           "reset_counts", "kernel_head_dim", "HEAD_DIMS"]

launches = 0
plain_calls = 0
dq_launches = 0
dq_plain_calls = 0
dkv_launches = 0
dkv_plain_calls = 0

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# pointers, then B, H, lq, lk, d, dtype, then 3 strides a tensor, then
# scale, causal, kv_len, device, stream
_TAIL = [ctypes.c_float, _I, _I, _I, _P]
_SIGNATURES = {"mxt_flash_attention_fwd": (
    _I, [_P] * 5 + [_I] * 6 + [_L] * 12 + _TAIL)}
_BWD_SIGNATURES = {
    "mxt_flash_attention_bwd_dq": (
        _I, [_P] * 7 + [_I] * 6 + [_L] * 15 + _TAIL),
    "mxt_flash_attention_bwd_dkv": (
        _I, [_P] * 8 + [_I] * 6 + [_L] * 18 + _TAIL),
}


def reset_counts():
    global launches, plain_calls, dq_launches, dq_plain_calls
    global dkv_launches, dkv_plain_calls
    launches = plain_calls = 0
    dq_launches = dq_plain_calls = 0
    dkv_launches = dkv_plain_calls = 0


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


def _check_bwd(q, do, lse, delta):
    b, h, lq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} "
                         f"is not q's {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, lq):
            raise ValueError(f"flash_attention backward: {name} "
                             f"{tuple(t.shape)} is not {(b, h, lq)}")


def _on_cpu(*ts):
    return all(t.device.type == "cpu" for t in ts)


def _kernel_args(q, k, v, extra=()):
    """Raise unless q, k, v (and `extra`, of q's dtype) can go to a kernel;
    returns ``(B, H, lq, lk, D)``."""
    ts = (q, k, v) + tuple(extra)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"flash_attention kernel needs its tensors on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"tensors of one dtype, got "
                        f"{[str(t.dtype) for t in ts]}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention kernel needs a unit stride on the "
                         "head dimension")
    if b * h >= 2 ** 31 or max(lq, lk) >= 2 ** 22:
        raise ValueError("flash_attention kernel: shape too large")
    return b, h, lq, lk, d


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _acc(dtype):
    """The type the plain versions compute in: f32, or f64 for f64 inputs
    (so that gradcheck can hold them in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def _mask(lq, lk, kv_len, causal, device):
    """(lq, lk) bool: True where row r may see key c."""
    col = torch.arange(lk, device=device)
    mask = (col < kv_len)[None, :].expand(lq, lk)
    if causal:
        row = torch.arange(lq, device=device)[:, None]
        mask = mask & (col[None, :] <= row + (lk - lq))
    return mask


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _blhd(b, h, length, d, like):
    """An empty (B, H, L, D) view of a contiguous (B, L, H, D) buffer."""
    return torch.empty((b, length, h, d), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def flash_attention_ref(q, k, v, *, causal=False, scale=None, kv_len=None):
    """The plain version, in f32: masked scores, exact softmax, ``(out in
    q's dtype, lse f32 (B, H, Lq))``. A row that sees no key gives 0 and an
    lse of -inf, as the kernel does."""
    kv_len = _check(q, k, v, causal, kv_len)
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    scale = _scale(scale, d)
    acc = _acc(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    s = s.masked_fill(~_mask(lq, lk, kv_len, causal, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ v.to(acc)) / torch.where(l == 0, torch.ones_like(l), l)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, causal=False, scale=None, kv_len=None):
    """Attention forward on (B, H, L, D) tensors: ``(out (B, H, Lq, D) in q's
    dtype, lse (B, H, Lq) f32)``. `scale` defaults to 1/sqrt(D); keys at or
    past `kv_len` (default Lk) are masked; `causal` masks bottom-right
    (row r sees keys c <= r + Lk - Lq). Not differentiable: see
    :func:`flash_attention`.

    CUDA tensors (f32 or bf16, D in ``HEAD_DIMS``, unit stride on D) launch
    the kernel on the current stream; it reads through the given strides and
    writes `out` as a (B, H, Lq, D) view of a contiguous (B, Lq, H, D)
    buffer, so merging heads afterwards is free. CPU tensors run
    :func:`flash_attention_ref`."""
    global launches, plain_calls
    kv_len = _check(q, k, v, causal, kv_len)
    if _on_cpu(q, k, v):
        plain_calls += 1
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len)
    b, h, lq, lk, d = _kernel_args(q, k, v)
    scale = _scale(scale, d)
    out = _blhd(b, h, lq, d, q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h == 0 or lq == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    rc = lib.mxt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, lq, lk, d, _DTYPES[q.dtype],
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        scale, int(bool(causal)), kv_len, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _p_and_ds(q, k, v, do, lse, delta, causal, scale, kv_len):
    """The explicit math of ``_masked_p`` and the dS line of the Pallas
    kernels, in f32: P = exp(scale*QK^T - lse) where the mask allows (a
    select, so an lse of -inf gives 0, not NaN), dS = P*(dO V^T - delta)*
    scale. Returns (P, dS, acc dtype)."""
    lq, lk = q.shape[2], k.shape[2]
    acc = _acc(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    mask = _mask(lq, lk, kv_len, causal, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    ds = p * (dp - delta.to(acc)[..., None]) * scale
    return p, ds, acc


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=False,
                               scale=None, kv_len=None):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    kv_len = _check(q, k, v, causal, kv_len)
    _check_bwd(q, do, lse, delta)
    _, ds, acc = _p_and_ds(q, k, v, do, lse, delta, causal,
                           _scale(scale, q.shape[3]), kv_len)
    return (ds @ k.to(acc)).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal=False,
                                scale=None, kv_len=None):
    """Plain version of the dK/dV kernel: ``(dK = dS^T Q, dV = P^T dO)``, in
    k's and v's dtypes."""
    kv_len = _check(q, k, v, causal, kv_len)
    _check_bwd(q, do, lse, delta)
    p, ds, acc = _p_and_ds(q, k, v, do, lse, delta, causal,
                           _scale(scale, q.shape[3]), kv_len)
    dk = ds.transpose(-1, -2) @ q.to(acc)
    dv = p.transpose(-1, -2) @ do.to(acc)
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(do, out):
    """delta = rowsum(dO * O) in f32 (f64 for f64 inputs): (B, H, Lq)."""
    acc = _acc(out.dtype)
    return (do.to(acc) * out.to(acc)).sum(-1)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=False,
                            scale=None, kv_len=None):
    """The plain backward, ``_bwd``'s explicit math (not autograd of the
    forward): delta, then P, dP and dS, then ``(dQ, dK, dV)``."""
    delta = _delta(do, out)
    kw = dict(causal=causal, scale=scale, kv_len=kv_len)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    return (dq,) + flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)


def _rows16(t):
    """The backward kernels copy rows 16 bytes at a time: a tensor whose
    pointer or (batch, head, row) strides are not multiples of 16 bytes goes
    in as a fresh contiguous copy (the QKV views of one projection need
    none)."""
    e = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * e % 16 == 0 for s in _strides(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch_bwd(fn, q, k, v, do, lse, delta, outs, causal, scale, kv_len):
    b, h, lq, lk, d = _kernel_args(q, k, v, (do,))
    q, k, v, do = (_rows16(t) for t in (q, k, v, do))
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    if lse.device != q.device or delta.device != q.device:
        raise ValueError("flash_attention backward: lse and delta must be "
                         "on q's device")
    if b * h == 0 or min(lq, lk) == 0:
        # no rows or no keys: the gradients are zero
        for t in outs:
            t.zero_()
        return False
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    rc = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, lq, lk, d, _DTYPES[q.dtype],
        *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        *(s for t in outs for s in _strides(t)),
        _scale(scale, d), int(bool(causal)), kv_len, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel {fn} launch "
                           f"failed: CUDA error {rc}")
    return True


def _unit_stride(do):
    """Autograd may hand over an expanded or permuted dO: the kernels need a
    unit stride on D and read every other stride as given."""
    return do if do.stride(3) == 1 else do.contiguous()


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=False,
                           scale=None, kv_len=None):
    """dQ (B, H, Lq, D) from the forward's lse and delta = rowsum(dO * O).
    CUDA tensors launch the dQ kernel, which writes dQ as a (B, H, Lq, D)
    view of a (B, Lq, H, D) buffer; CPU tensors run
    :func:`flash_attention_bwd_dq_ref`."""
    global dq_launches, dq_plain_calls
    kv_len = _check(q, k, v, causal, kv_len)
    _check_bwd(q, do, lse, delta)
    if _on_cpu(q, k, v, do):
        dq_plain_calls += 1
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                          causal=causal, scale=scale,
                                          kv_len=kv_len)
    do = _unit_stride(do)
    b, h, lq, d = q.shape
    dq = _blhd(b, h, lq, d, q)
    if _launch_bwd("mxt_flash_attention_bwd_dq", q, k, v, do, lse, delta,
                   (dq,), causal, scale, kv_len):
        dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=False,
                            scale=None, kv_len=None):
    """``(dK, dV)``, each (B, H, Lk, D), from the forward's lse and delta.
    CUDA tensors launch the dK/dV kernel, which writes both as (B, H, Lk, D)
    views of (B, Lk, H, D) buffers; CPU tensors run
    :func:`flash_attention_bwd_dkv_ref`."""
    global dkv_launches, dkv_plain_calls
    kv_len = _check(q, k, v, causal, kv_len)
    _check_bwd(q, do, lse, delta)
    if _on_cpu(q, k, v, do):
        dkv_plain_calls += 1
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                           causal=causal, scale=scale,
                                           kv_len=kv_len)
    do = _unit_stride(do)
    b, h, lk, d = k.shape
    dk, dv = _blhd(b, h, lk, d, k), _blhd(b, h, lk, d, v)
    if _launch_bwd("mxt_flash_attention_bwd_dkv", q, k, v, do, lse, delta,
                   (dk, dv), causal, scale, kv_len):
        dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=False, scale=None,
                        kv_len=None):
    """The backward of :func:`flash_attention_fwd`: ``(dQ, dK, dV)`` from its
    inputs, its ``out`` and ``lse``, and dO. delta = rowsum(dO * O) is one
    PyTorch op; then the dQ and the dK/dV kernels run (their plain versions
    for CPU tensors)."""
    if out.shape != q.shape:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} "
                         f"is not q's {tuple(q.shape)}")
    delta = _delta(do, out)
    kw = dict(causal=causal, scale=scale, kv_len=kv_len)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)


def kernel_head_dim(d):
    """The head dim a call of head dim `d` runs at: the least of
    ``HEAD_DIMS`` that holds it, or `d` itself above them (which the kernels
    refuse)."""
    return next((k for k in HEAD_DIMS if k >= d), d)


def _pad(t, dp):
    """`t` with zero columns on D up to `dp` (`t` itself at `dp`)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


class FlashAttentionFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the Pallas flash attention: the forward saves
    q, k, v, out and lse; the backward runs :func:`flash_attention_bwd`. The
    lse output is not differentiable.

    A head dim the kernels do not take runs padded, on either device, as
    the Pallas module pads D to 128 lanes: q, k and v get zero columns up to
    :func:`kernel_head_dim`, the scale stays 1/sqrt(D), and out, dQ, dK and
    dV are sliced back. Zero columns add nothing to a score and give zero
    output columns; dO gets zero columns for the backward. A D above 128
    raises on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        d = q.shape[-1]
        dp = kernel_head_dim(d)
        if dp != d:
            scale = _scale(scale, d)
            q, k, v = (_pad(t, dp) for t in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, scale=scale, kv_len=kv_len)
        ctx.mark_non_differentiable(lse)
        return out[..., :d], lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        d = dout.shape[-1]
        grads = flash_attention_bwd(q, k, v, out, lse,
                                    _pad(dout, q.shape[-1]), **ctx.cfg)
        return tuple(g[..., :d] for g in grads) + (None, None, None)


def flash_attention(q, k, v, *, causal=False, scale=None, kv_len=None):
    """Differentiable attention on (B, H, L, D) tensors: (B, H, Lq, D).
    Forward and backward take the kernels for CUDA tensors and the plain
    versions for CPU tensors; on the card any D up to 128 runs (see
    :class:`FlashAttentionFunction`)."""
    return FlashAttentionFunction.apply(q, k, v, causal, scale, kv_len)[0]
