"""Fused conv + BatchNorm + activation: the CUDA kernels of
``csrc/conv_bn_relu.cu``, their wrappers, their plain PyTorch versions, and
the ``torch.autograd.Function``s that give them a backward.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/conv_bn_relu.py``:

* :func:`scale_shift_act` — ``act(x * scale + shift)`` over the last axis
  in one pass over memory (``_ssa_fwd_impl``'s kernel). Training-mode
  BatchNormReLU applies its folded batch statistics through it, and the
  general-geometry conv path uses it as its epilogue. Its backward is the
  closed form of ``_ssa_bwd`` in PyTorch ops: the JAX package computes it
  in XLA, outside any Pallas kernel.
* :func:`conv_bn_relu` — NHWC conv + BatchNorm (moving statistics) + act.
  A 1x1, stride-1, unpadded conv is a matrix product over flattened pixels
  and runs whole in the GEMM kernel with the epilogue fused
  (``_mm_epilogue``'s kernel); any other geometry runs PyTorch's conv
  (cuDNN on the card, as the JAX package leaves the conv to XLA) and then
  the scale/shift/act kernel. Its backward re-derives through the plain
  conv -> affine -> act formulation with ``torch.autograd``, as ``_cbr_bwd``
  does.

Each wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor; there is no other switch and no fallback. ``ssa_launches`` and
``mm_launches`` count kernel launches, ``ssa_plain_calls`` and
``mm_plain_calls`` calls that took the plain version. ``nhwc_copies``
counts the conv outputs that came back in another layout than NHWC and had
to be copied before the epilogue could read them as (rows, C).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["ACTS", "fold_bn", "scale_shift_act", "scale_shift_act_fwd",
           "scale_shift_act_ref", "scale_shift_act_bwd",
           "ScaleShiftActFunction", "mm_epilogue", "mm_epilogue_ref",
           "conv_nhwc", "conv_bn_ref", "conv_bn_relu", "ConvBNReLUFunction",
           "ssa_launches", "ssa_plain_calls", "mm_launches",
           "mm_plain_calls", "nhwc_copies", "reset_counts"]

ssa_launches = 0
ssa_plain_calls = 0
mm_launches = 0
mm_plain_calls = 0
nhwc_copies = 0

# the activations the epilogue kernels implement, by the kernels' codes;
# the selection rules admit exactly these
ACTS = {None: 0, "relu": 1, "relu6": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mxt_scale_shift_act": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]),
    "mxt_mm_epilogue": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}
# the GEMM kernel's grid has one row of blocks per 128 rows, at most 65535
_MM_MAX_ROWS = 65535 * 128


def reset_counts():
    global ssa_launches, ssa_plain_calls, mm_launches, mm_plain_calls
    global nhwc_copies
    ssa_launches = ssa_plain_calls = mm_launches = mm_plain_calls = 0
    nhwc_copies = 0


def _acc(dtype):
    """f32, or f64 for f64 inputs (so that gradcheck can hold the plain
    versions in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def _act_code(act):
    if act not in ACTS:
        raise ValueError(f"scale_shift_act: unsupported act {act!r} "
                         "(relu, relu6 or None)")
    return ACTS[act]


def _apply_act(y, act):
    _act_code(act)
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    return y


def fold_bn(gamma, beta, mean, var, eps):
    """BatchNorm as an affine epilogue: ``scale = gamma * rsqrt(var + eps)``,
    ``shift = beta - mean * scale``, in f32 (f64 for f64 inputs).
    Differentiable: in training mode the gradient runs through `mean` and
    `var` into the batch they came from."""
    acc = _acc(var.dtype)
    inv = torch.rsqrt(var.to(acc) + eps)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean.to(acc) * scale
    return scale, shift


# ---------------------------------------------------------------------------
# scale, shift, activation
# ---------------------------------------------------------------------------

def scale_shift_act_ref(x, scale, shift, act="relu"):
    """The plain version: ``act(x * scale + shift)`` over the last axis in
    f32 (f64 for f64 inputs), cast back to x's dtype (``_ssa_kernel``'s
    arithmetic). Differentiable by autograd."""
    acc = _acc(x.dtype)
    y = x.to(acc) * scale.to(acc) + shift.to(acc)
    return _apply_act(y, act).to(x.dtype)


def _check_ssa(x, scale, shift):
    c = x.shape[-1]
    if scale.shape != (c,) or shift.shape != (c,):
        raise ValueError(f"scale_shift_act: scale {tuple(scale.shape)} and "
                         f"shift {tuple(shift.shape)} must be ({c},)")


def scale_shift_act_fwd(x, scale, shift, act="relu"):
    """``act(x * scale + shift)`` over the last axis of `x` with 1-D
    `scale`/`shift` of its width. A CUDA `x` (f32 or bf16, contiguous)
    launches the kernel on the current stream; a CPU `x` runs
    :func:`scale_shift_act_ref`. Not differentiable: see
    :func:`scale_shift_act`."""
    global ssa_launches, ssa_plain_calls
    _check_ssa(x, scale, shift)
    code = _act_code(act)
    if x.device.type == "cpu":
        ssa_plain_calls += 1
        return scale_shift_act_ref(x, scale, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"scale_shift_act: no kernel for device {x.device}")
    if scale.device != x.device or shift.device != x.device:
        raise ValueError("scale_shift_act: x, scale and shift must share a "
                         "device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scale_shift_act kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("scale_shift_act kernel needs a contiguous x")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    s = scale.to(torch.float32).contiguous()
    b = shift.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.load("conv_bn_relu", _SIGNATURES)
    rc = lib.mxt_scale_shift_act(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), rows, c,
        code, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scale_shift_act kernel launch failed: CUDA "
                           f"error {rc}")
    ssa_launches += 1
    return y


def scale_shift_act_bwd(x, scale, shift, dy, act):
    """The closed form of ``_ssa_bwd``: the mask from the recomputed
    pre-activation (``pre > 0`` for relu, ``0 < pre < 6`` for relu6), then
    ``(dx in x's dtype, dscale, dshift in their dtypes)``, the channel
    gradients summed over every leading axis."""
    c = x.shape[-1]
    acc = _acc(x.dtype)
    xf = x.reshape(-1, c).to(acc)
    g = dy.reshape(-1, c).to(acc)
    if act is not None:
        pre = xf * scale.to(acc) + shift.to(acc)
        mask = pre > 0
        if act == "relu6":
            mask = mask & (pre < 6.0)
        g = torch.where(mask, g, torch.zeros((), dtype=acc, device=g.device))
    dx = (g * scale.to(acc)).to(x.dtype).reshape(x.shape)
    return dx, (g * xf).sum(0).to(scale.dtype), g.sum(0).to(shift.dtype)


class ScaleShiftActFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the Pallas ``_ssa``: the forward runs
    :func:`scale_shift_act_fwd` and saves x, scale and shift; the backward
    is :func:`scale_shift_act_bwd`."""

    @staticmethod
    def forward(ctx, x, scale, shift, act):
        y = scale_shift_act_fwd(x, scale, shift, act)
        ctx.save_for_backward(x, scale, shift)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift = ctx.saved_tensors
        return (*scale_shift_act_bwd(x, scale, shift, dy, ctx.act), None)


def scale_shift_act(x, scale, shift, act="relu"):
    """Differentiable ``act(x * scale + shift)`` over the last axis of `x`:
    the kernel forward for a CUDA `x`, the plain version for a CPU `x`,
    and the closed-form backward on both."""
    return ScaleShiftActFunction.apply(x, scale, shift, act)


# ---------------------------------------------------------------------------
# (M, K) @ (K, N) with the scale, shift and activation epilogue
# ---------------------------------------------------------------------------

def mm_epilogue_ref(x2, w2, scale, shift, act="relu"):
    """The plain version: ``act((x2 @ w2) * scale + shift)`` with the
    product and the epilogue in f32 (f64 for f64 inputs), cast to x2's
    dtype (``_mm_kernel``'s arithmetic)."""
    acc = _acc(x2.dtype)
    y = (x2.to(acc) @ w2.to(acc)) * scale.to(acc) + shift.to(acc)
    return _apply_act(y, act).to(x2.dtype)


def mm_epilogue(x2, w2, scale, shift, act="relu"):
    """(M, K) @ (K, N) with the per-column scale, shift and activation
    applied to the f32 sums before the one write. A CUDA `x2` (f32 or
    bf16; `w2` of the same dtype; both contiguous) launches the GEMM
    kernel; a CPU `x2` runs :func:`mm_epilogue_ref`. Not differentiable:
    :func:`conv_bn_relu` gives it a backward."""
    global mm_launches, mm_plain_calls
    code = _act_code(act)
    m, k = x2.shape
    if w2.ndim != 2 or w2.shape[0] != k:
        raise ValueError(f"mm_epilogue: x2 {tuple(x2.shape)} and w2 "
                         f"{tuple(w2.shape)} do not chain")
    n = w2.shape[1]
    if scale.shape != (n,) or shift.shape != (n,):
        raise ValueError(f"mm_epilogue: scale {tuple(scale.shape)} and "
                         f"shift {tuple(shift.shape)} must be ({n},)")
    if x2.device.type == "cpu":
        mm_plain_calls += 1
        return mm_epilogue_ref(x2, w2, scale, shift, act)
    if x2.device.type != "cuda":
        raise ValueError(f"mm_epilogue: no kernel for device {x2.device}")
    if any(t.device != x2.device for t in (w2, scale, shift)):
        raise ValueError("mm_epilogue: x2, w2, scale and shift must share a "
                         "device")
    if x2.dtype not in _DTYPES or w2.dtype != x2.dtype:
        raise TypeError(f"mm_epilogue kernel takes float32 or bfloat16 x2 "
                        f"and w2 of one dtype, got {x2.dtype} and "
                        f"{w2.dtype}")
    if not (x2.is_contiguous() and w2.is_contiguous()):
        raise ValueError("mm_epilogue kernel needs contiguous x2 and w2")
    if m > _MM_MAX_ROWS or max(k, n) >= 2 ** 31:
        raise ValueError(f"mm_epilogue kernel takes at most {_MM_MAX_ROWS} "
                         f"rows and < 2**31 columns, got {tuple(x2.shape)} "
                         f"@ {tuple(w2.shape)}")
    s = scale.to(torch.float32).contiguous()
    b = shift.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("conv_bn_relu", _SIGNATURES)
    rc = lib.mxt_mm_epilogue(
        x2.data_ptr(), w2.data_ptr(), s.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, n, k, code, _DTYPES[x2.dtype], x2.device.index,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_epilogue kernel launch failed: CUDA error "
                           f"{rc}")
    mm_launches += 1
    return out


# ---------------------------------------------------------------------------
# conv + BN + act
# ---------------------------------------------------------------------------

def conv_nhwc(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), groups=1):
    """2-D convolution of an NHWC `x` with an HWIO `w` (the JAX package's
    ``("NHWC", "HWIO", "NHWC")``), through ``F.conv2d`` on channels-last
    views: cuDNN reads x and writes the result in NHWC order without a
    transpose. Returns an NHWC-contiguous result; one that came back in
    another layout is copied and counted in ``nhwc_copies``."""
    global nhwc_copies
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                 tuple(stride), tuple(pad), tuple(dilate), groups)
    y = y.permute(0, 2, 3, 1)
    if not y.is_contiguous():
        nhwc_copies += 1
        y = y.contiguous()
    return y


def conv_bn_ref(x, w, scale, shift, stride=(1, 1), pad=(0, 0), act="relu"):
    """The plain formulation (``_conv_ref``): conv, then the affine in f32
    and the activation, cast to x's dtype. The backward's re-derivation
    target and the parity oracle."""
    y = conv_nhwc(x, w, stride, pad)
    acc = _acc(y.dtype)
    y = y.to(acc) * scale.to(acc) + shift.to(acc)
    return _apply_act(y, act).to(x.dtype)


def _one_by_one(w, stride, pad):
    return (w.shape[0] == 1 and w.shape[1] == 1 and tuple(stride) == (1, 1)
            and tuple(pad) == (0, 0))


def _cbr_fwd(x, w, scale, shift, stride, pad, act):
    """``_cbr_fwd_impl``: 1x1/stride-1/unpadded as one GEMM with the fused
    epilogue, any other geometry as conv + the scale/shift/act kernel."""
    global nhwc_copies
    if _one_by_one(w, stride, pad):
        n, h, wd, cin = x.shape
        if not x.is_contiguous():
            nhwc_copies += 1
            x = x.contiguous()
        out = mm_epilogue(x.reshape(n * h * wd, cin),
                          w.reshape(cin, w.shape[-1]), scale, shift, act)
        return out.reshape(n, h, wd, w.shape[-1])
    return scale_shift_act_fwd(conv_nhwc(x, w, stride, pad), scale, shift,
                               act)


class ConvBNReLUFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the Pallas ``_cbr``: the forward runs the
    kernels and saves x, w, scale and shift; the backward re-derives through
    :func:`conv_bn_ref` with ``torch.autograd`` (one extra forward, as
    ``_cbr_bwd`` does; the fused path serves inference, where no backward
    runs)."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, pad, act):
        y = _cbr_fwd(x, w, scale, shift, stride, pad, act)
        ctx.save_for_backward(x, w, scale, shift)
        ctx.geometry = (tuple(stride), tuple(pad), act)
        return y

    @staticmethod
    def backward(ctx, dy):
        stride, pad, act = ctx.geometry
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = conv_bn_ref(*leaves, stride, pad, act)
            grads = torch.autograd.grad(y, leaves, dy)
        return (*grads, None, None, None)


def conv_bn_relu(x, weight, gamma, beta, mean, var, eps=1e-5, stride=(1, 1),
                 pad=(0, 0), act="relu"):
    """Fused NHWC conv + BatchNorm (moving statistics) + activation: x (N,
    H, W, Cin), weight HWIO. BN is applied after the conv's sum, in the same
    order as the unfused path (the weights are not pre-folded)."""
    _act_code(act)
    scale, shift = fold_bn(gamma, beta, mean, var, eps)
    return ConvBNReLUFunction.apply(x, weight, scale, shift, tuple(stride),
                                    tuple(pad), act)
