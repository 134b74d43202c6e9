"""FrozenModel — a serving-ready snapshot of a module, warmed per batch
bucket (counterpart of ``incubator_mxnet_tpu/serving/frozen.py``).

* **freeze** — the module is deep-copied onto the serving device in eval
  mode with gradients off; later training of the source module does not
  reach the snapshot, and every forward runs under
  ``torch.inference_mode()``;
* **buckets** — requests are padded up to the smallest batch bucket that
  fits, so the device only ever sees a fixed ladder of batch shapes;
* **warmup** — each bucket runs once at construction, so the first
  requests do not pay for lazy set-up (cuBLAS handles, kernel builds,
  allocator growth).

The JAX package compiles one XLA executable per bucket here. PyTorch runs
eagerly; capturing a CUDA graph per bucket is later work.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .. import profiler as _prof
from ..context import as_context
from .errors import InvalidInputError

__all__ = ["FrozenModel", "default_buckets"]


def default_buckets(max_batch: int | None = None):
    """Power-of-two bucket ladder up to `max_batch` (default 32)."""
    sizes, b = [], 1
    cap = int(max_batch or 32)
    if cap < 1:
        raise ValueError(f"invalid max_batch {max_batch!r}")
    while b < cap:
        sizes.append(b)
        b *= 2
    sizes.append(cap)
    return tuple(sorted(set(sizes)))


def _flatten_out(out):
    """A tensor or a flat tuple/list of tensors -> (leaves, tree)."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)) and all(
            isinstance(o, torch.Tensor) for o in out):
        return list(out), type(out)
    raise TypeError("FrozenModel serves modules that return a tensor or a "
                    f"flat tuple/list of tensors, got {type(out).__name__}")


def _unflatten_out(tree, leaves):
    return leaves[0] if tree is None else tree(leaves)


class FrozenModel:
    """An immutable, serving-ready snapshot of a ``torch.nn.Module``.

    Parameters
    ----------
    block : torch.nn.Module
        The trained model. It is deep-copied; the source is not touched.
    input_shape : tuple
        PER-SAMPLE input shape (no batch dimension).
    dtype : str
        Input dtype requests must match.
    batch_buckets : sequence of int, optional
        Batch sizes to serve; default :func:`default_buckets`.
    ctx : Context, optional
        Device to serve on; default ``gpu(0)``, which raises on a machine
        without a card. Pass ``cpu()`` to serve on the CPU.
    warmup : bool
        Run each bucket once at construction (default True).
    """

    def __init__(self, block, input_shape, dtype="float32",
                 batch_buckets=None, ctx=None, warmup=True):
        if not isinstance(block, torch.nn.Module):
            raise TypeError("FrozenModel requires a torch.nn.Module, got "
                            f"{type(block).__name__}")
        self._device = as_context(ctx).device
        self._input_shape = tuple(int(d) for d in input_shape)
        self._dtype = np.dtype(dtype)
        self.buckets = (tuple(sorted({int(b) for b in batch_buckets}))
                        if batch_buckets else default_buckets())
        if self.buckets[0] < 1:
            raise ValueError(f"invalid serving buckets {self.buckets!r}")
        self._name = type(block).__name__
        self._module = copy.deepcopy(block).to(self._device).eval()
        self._module.requires_grad_(False)
        self._out_tree = None
        if warmup:
            for b in self.buckets:
                self.run_raw(np.zeros((b,) + self._input_shape, self._dtype))
                self._sync()
                _prof.counter("serving.warmup_runs", "serving").increment()

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # -- execution --------------------------------------------------------
    @property
    def input_shape(self):
        return self._input_shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits n samples."""
        for b in self.buckets:
            if b >= n:
                return b
        raise InvalidInputError(
            f"batch of {n} exceeds the largest bucket ({self.buckets[-1]}); "
            f"freeze with larger batch_buckets")

    def validate(self, x: np.ndarray):
        """Shape/dtype admission check for ONE sample (no batch dim)."""
        if tuple(x.shape) != self._input_shape:
            raise InvalidInputError(
                f"sample shape {tuple(x.shape)} != expected "
                f"{self._input_shape}")
        if np.dtype(x.dtype) != self._dtype:
            raise InvalidInputError(
                f"sample dtype {x.dtype} != expected {self._dtype.name}")

    def run_raw(self, x) -> tuple:
        """Run the bucket exactly matching ``x.shape[0]``. Returns the flat
        tuple of output tensors, still batched and padded, on the device.
        Does not wait for the device."""
        n = int(x.shape[0])
        if n not in self.buckets:
            raise InvalidInputError(
                f"no bucket for batch {n}; buckets={self.buckets}")
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=self._dtype))
        with torch.inference_mode():
            leaves, tree = _flatten_out(self._module(xt.to(self._device)))
        self._out_tree = tree
        _prof.counter("serving.executed_batches", "serving").increment()
        return tuple(leaves)

    def predict_batch(self, x: np.ndarray, timings: dict | None = None) \
            -> list:
        """Serve a host batch of n <= max_batch samples: pad up to the
        bucket, run, slice back to n. Returns the per-output list of numpy
        arrays (length n each). Rows are independent in inference, so pad
        rows never change real rows.

        ``timings``: when a dict is passed it is filled with the phase
        split ``{"pad_ms", "exec_ms", "unpad_ms"}``; ``exec_ms`` ends at a
        ``torch.cuda.synchronize()`` on a CUDA device, so it holds the
        device time, and ``unpad_ms`` is the copy back to the host."""
        n = int(x.shape[0])
        b = self.bucket_for(n)
        t0 = time.perf_counter()
        if b != n:
            pad = np.zeros((b - n,) + self._input_shape, self._dtype)
            x = np.concatenate([np.ascontiguousarray(x), pad], axis=0)
        t1 = time.perf_counter()
        outs = self.run_raw(x)
        if timings is not None:
            self._sync()
        t2 = time.perf_counter()
        res = [o[:n].cpu().numpy() for o in outs]
        t3 = time.perf_counter()
        if timings is not None:
            timings["pad_ms"] = (t1 - t0) * 1e3
            timings["exec_ms"] = (t2 - t1) * 1e3
            timings["unpad_ms"] = (t3 - t2) * 1e3
        return res

    def __call__(self, x):
        """``block(x)`` on a batch (numpy array or tensor WITH batch dim):
        returns CPU tensor(s) in the block's output structure."""
        x_np = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))
        outs = self.predict_batch(x_np.astype(self._dtype, copy=False))
        return _unflatten_out(self._out_tree,
                              [torch.from_numpy(o) for o in outs])

    def __repr__(self):
        return (f"FrozenModel({self._name}, input={self._input_shape}, "
                f"dtype={self._dtype.name}, buckets={self.buckets}, "
                f"device={self._device})")
