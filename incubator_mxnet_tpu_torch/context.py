"""Device contexts over ``torch.device`` (counterpart of
``incubator_mxnet_tpu/context.py``).

``gpu(i)`` and ``tpu(i)`` both name ``cuda:i``, so scripts written for the
JAX package run unchanged; ``cpu()`` names the CPU. Two contexts are equal
when their type and index are (``cpu() == cpu()``), so they key dicts and
sets. ``with ctx:`` makes `ctx` the current context of this thread until
the scope ends (scopes nest); outside every scope the current context is
the default, ``gpu(0)``. What takes ``ctx=None`` (``nd.array``,
``initialize``, the models) lands on the current context. Resolving a
CUDA context on a machine without a usable card raises: nothing moves to
the CPU unless the caller asks for ``cpu()``.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "default_context", "as_context",
           "current_context", "num_gpus", "num_tpus", "ctx_from_device",
           "gpu_memory_info"]

_CUDA_TYPES = ("gpu", "tpu", "cuda")


class Context:
    """A device context: ``device_type`` is "cpu", "gpu" or "tpu".
    ``with ctx:`` scopes the current context (:meth:`current`)."""

    _tls = threading.local()

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
        n = num_gpus()
        if self.device_id >= n:
            raise RuntimeError(
                f"{self!r} needs CUDA device {self.device_id}, but this "
                f"machine has {n} usable CUDA device(s); pass ctx=cpu() to "
                f"run on the CPU")
        return torch.device("cuda", self.device_id)

    # -- identity ---------------------------------------------------------
    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    # -- scoping ----------------------------------------------------------
    def __enter__(self):
        if not hasattr(Context._tls, "stack"):
            Context._tls.stack = []
        Context._tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._tls.stack.pop()
        return False

    @classmethod
    def current(cls) -> "Context":
        """The innermost ``with`` context of this thread, else
        :func:`default_context`."""
        stack = getattr(cls._tls, "stack", None)
        if stack:
            return stack[-1]
        return default_context()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The accelerator name scripts of the JAX package use: ``cuda:i``."""
    return Context("tpu", device_id)


def default_context() -> Context:
    return gpu(0)


def current_context() -> Context:
    return Context.current()


def as_context(ctx) -> Context:
    """`ctx`, or :func:`current_context` for None."""
    if ctx is None:
        return Context.current()
    if not isinstance(ctx, Context):
        raise TypeError(f"expected a Context such as cpu() or gpu(0), got "
                        f"{type(ctx).__name__}")
    return ctx


def num_gpus() -> int:
    """The usable CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus() -> int:
    """The devices ``tpu(i)`` can name: the CUDA devices, as ``tpu(i)``
    is ``cuda:i`` here."""
    return num_gpus()


def ctx_from_device(device) -> Context:
    """The context of a ``torch.device`` (or its name): ``gpu(i)`` for
    ``cuda:i``, ``cpu()`` for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return gpu(torch.cuda.current_device() if device.index is None
                   else device.index)
    if device.type == "cpu":
        return cpu()
    raise ValueError(f"no context for device {device}")


def gpu_memory_info(device_id=0):
    """(free, total) bytes of CUDA device `device_id`
    (``torch.cuda.mem_get_info``); raises without that device."""
    if device_id >= num_gpus():
        raise ValueError(f"no CUDA device {device_id} (have {num_gpus()})")
    return torch.cuda.mem_get_info(device_id)
