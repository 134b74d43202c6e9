"""Kernel selection: the qualification rules that decide, per call, whether
an op goes to its hand-written kernel (counterpart of
``incubator_mxnet_tpu/ops/select.py``).

Once a call qualifies, the device of its tensors decides: a CPU tensor runs
the kernel's plain version, a CUDA tensor launches the kernel or raises.
There is no global switch.

===============  ======================================================
kernel           qualifies when
===============  ======================================================
flash_attention  no additive mask; no attention-weight dropout in
                 training mode (the kernel applies no dropout)
layer_norm       normalized axis is the last axis; 1-D gamma
===============  ======================================================
"""
from __future__ import annotations

__all__ = ["flash_attention", "layer_norm"]


def flash_attention(mask, dropout_active: bool) -> bool:
    """Qualify the flash-attention kernel for a multi-head attention call."""
    return mask is None and not dropout_active


def layer_norm(x, gamma, axis) -> bool:
    """Qualify the layer-norm kernel (last axis, 1-D gamma)."""
    return axis in (-1, x.ndim - 1) and gamma.ndim == 1
