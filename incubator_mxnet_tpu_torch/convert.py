"""Carry parameter values from the JAX package into a port module.

The JAX side names parameters structurally
(``net._collect_params_with_prefix()``: ``encoder.cells.0.attention.qkv.
weight``, ``features.1.running_mean``, ...), and the port's modules use the
same attribute names, so those names are the port module's
``named_parameters()`` and ``named_buffers()`` keys: BatchNorm's moving
statistics are buffers in the port and parameters with ``grad_req="null"``
on the JAX side. Values pass as numpy arrays: this module never imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, arrays: dict):
    """Copy ``{structural_name: np.ndarray}`` into `module`'s parameters and
    buffers, keeping each one's device and dtype. Raises ValueError when a
    name is missing, extra, or of another shape; nothing is copied then."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    missing = sorted(set(targets) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing {missing}, extra {extra}")
    shapes = {n: tuple(np.shape(a)) for n, a in arrays.items()}
    bad = {n: (shapes[n], tuple(t.shape)) for n, t in targets.items()
           if shapes[n] != tuple(t.shape)}
    if bad:
        raise ValueError("load_jax_params: shape mismatch (given, expected): "
                         f"{bad}")
    for name, t in targets.items():
        a = np.asarray(arrays[name])
        if a.dtype.name == "bfloat16":        # ml_dtypes: widen for torch
            a = a.astype(np.float32)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(t.dtype))
    return module
