"""Device contexts over ``torch.device`` (counterpart of
``incubator_mxnet_tpu/context.py``).

``gpu(i)`` and ``tpu(i)`` both name ``cuda:i``, so scripts written for the
JAX package run unchanged; ``cpu()`` names the CPU. The default context is
``gpu(0)``. Resolving a CUDA context on a machine without a usable card
raises: nothing moves to the CPU unless the caller asks for ``cpu()``.
"""
from __future__ import annotations

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "default_context", "as_context"]

_CUDA_TYPES = ("gpu", "tpu", "cuda")


class Context:
    """A device context: ``device_type`` is "cpu", "gpu" or "tpu"."""

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in ("cpu",) + _CUDA_TYPES:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = str(device_type)
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        """The ``torch.device``; raises for a CUDA context without a card."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise RuntimeError(
                f"{self!r} needs CUDA device {self.device_id}, but this "
                f"machine has {n} usable CUDA device(s); pass ctx=cpu() to "
                f"run on the CPU")
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The accelerator name scripts of the JAX package use: ``cuda:i``."""
    return Context("tpu", device_id)


def default_context() -> Context:
    return gpu(0)


def as_context(ctx) -> Context:
    """`ctx`, or :func:`default_context` for None."""
    if ctx is None:
        return default_context()
    if not isinstance(ctx, Context):
        raise TypeError(f"expected a Context such as cpu() or gpu(0), got "
                        f"{type(ctx).__name__}")
    return ctx
