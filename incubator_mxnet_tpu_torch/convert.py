"""Carry parameter values from the JAX package into a port module.

The JAX side names parameters structurally
(``net._collect_params_with_prefix()``: ``encoder.cells.0.attention.qkv.
weight``, ``features.1.running_mean``, ...), and the port's modules use the
same attribute names, so those names are the port module's
``named_parameters()`` and ``named_buffers()`` keys: BatchNorm's moving
statistics are buffers in the port and parameters with ``grad_req="null"``
on the JAX side. A parameter whose shape is still deferred takes the
array's shape, as ``Parameter.set_data`` gives it. Values pass as numpy
arrays: this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn.parameter import is_lazy

__all__ = ["load_jax_params"]


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, arrays: dict):
    """Copy ``{structural_name: np.ndarray}`` into `module`'s parameters and
    buffers, keeping each one's device and dtype; a deferred Gluon
    parameter takes the array's shape (on the device the module was moved
    to). Raises ValueError when a name is missing, extra, or of another
    shape; nothing is copied then."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    missing = sorted(set(targets) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing {missing}, extra {extra}")
    shapes = {n: tuple(np.shape(a)) for n, a in arrays.items()}
    lazy = {n for n, t in targets.items() if is_lazy(t)}
    gluon = (module._collect_params_with_prefix()
             if hasattr(module, "_collect_params_with_prefix") else {})
    bad = {n: (shapes[n], tuple(t.shape)) for n, t in targets.items()
           if n not in lazy and shapes[n] != tuple(t.shape)}
    bad.update({n: (shapes[n], "deferred") for n in lazy
                if n not in gluon})
    if bad:
        raise ValueError("load_jax_params: shape mismatch (given, expected): "
                         f"{bad}")
    for name, t in targets.items():
        a = np.asarray(arrays[name])
        if a.dtype.name == "bfloat16":        # ml_dtypes: widen for torch
            a = a.astype(np.float32)
        a = torch.from_numpy(np.ascontiguousarray(a))
        if name in lazy:
            gluon[name].set_data(a)
        else:
            t.copy_(a.to(t.dtype))
    return module
