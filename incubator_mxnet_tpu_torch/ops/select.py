"""Kernel selection: the qualification rules that decide, per call, whether
an op goes to its hand-written kernel (counterpart of
``incubator_mxnet_tpu/ops/select.py``).

Once a call qualifies, the device of its tensors decides: a CPU tensor runs
the kernel's plain version, a CUDA tensor launches the kernel or raises.
There is no global switch. The TPU-only conditions of the JAX package (the
128-lane alignment of widths and channels) do not apply to the card.

Every decision is counted, as in the JAX package: ``ops/kernel.selected.
<kernel>`` and ``ops/kernel.rejected.<kernel>`` in ``profiler``.

===============  ======================================================
kernel           qualifies when
===============  ======================================================
flash_attention  no additive mask; no attention-weight dropout in
                 training mode (the kernel applies no dropout)
layer_norm       normalized axis is the last axis; 1-D gamma
scale_shift_act  channels-last input (the BatchNorm+ReLU tail as one
                 pass over memory); act in (None, relu, relu6)
conv_bn_relu     predict mode (BN with moving statistics); NHWC;
                 ungrouped, undilated; act in (None, relu, relu6). A
                 1x1/stride-1/unpadded conv runs as one GEMM with the
                 epilogue fused, any other geometry keeps PyTorch's conv
                 and fuses only the epilogue
===============  ======================================================
"""
from __future__ import annotations

from .. import profiler as _prof
from .cuda.conv_bn_relu import ACTS as _EPILOGUE_ACTS

__all__ = ["flash_attention", "layer_norm", "scale_shift_act",
           "conv_bn_relu"]


def _decide(kernel: str, ok: bool) -> bool:
    _prof.counter(("kernel.selected." if ok else "kernel.rejected.")
                  + kernel, "ops").increment()
    return ok


def flash_attention(mask, dropout_active: bool) -> bool:
    """Qualify the flash-attention kernel for a multi-head attention call."""
    return _decide("flash_attention", mask is None and not dropout_active)


def layer_norm(x, gamma, axis) -> bool:
    """Qualify the layer-norm kernel (last axis, 1-D gamma)."""
    return _decide("layer_norm",
                   axis in (-1, x.ndim - 1) and gamma.ndim == 1)


def scale_shift_act(x, channel_axis, act=None) -> bool:
    """Qualify the fused scale+shift+activation kernel: channels last."""
    return _decide("scale_shift_act", act in _EPILOGUE_ACTS
                   and channel_axis % x.ndim == x.ndim - 1)


def conv_bn_relu(x, weight, stride, pad, dilate, num_group, layout,
                 training: bool, act="relu") -> bool:
    """Qualify the fused conv+BN+act path (predict mode: the epilogue
    applies the folded moving statistics)."""
    return _decide("conv_bn_relu", act in _EPILOGUE_ACTS and not training
                   and layout == "NHWC" and num_group == 1
                   and (dilate is None or all(d == 1 for d in dilate)))
