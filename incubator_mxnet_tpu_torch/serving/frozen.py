"""FrozenModel — a serving-ready snapshot of a module, compiled per batch
bucket (counterpart of ``incubator_mxnet_tpu/serving/frozen.py``).

* **freeze** — the module is deep-copied onto the serving device in eval
  mode with gradients off; later training of the source module does not
  reach the snapshot, and every forward runs under
  ``torch.inference_mode()``;
* **buckets** — requests are padded up to the smallest batch bucket that
  fits, so the device only ever sees a fixed ladder of batch shapes;
* **compile** — on a CUDA device each bucket becomes one captured CUDA
  graph at construction, as the JAX package compiles one XLA executable
  per bucket (``_compile_bucket``): one eager forward on a side stream
  first (it builds the kernels and creates the library handles, so
  nothing of that runs inside a capture), then the capture of the forward
  reading a static input of the bucket's shape, largest bucket first, all
  graphs in one memory pool. A request is one replay: its batch is copied
  into the bucket's pinned staging buffer, uploaded asynchronously into
  the static input, and the graph runs with no per-op host work. Counted
  in ``serving.compiles``; ``serving.compiled_buckets`` is the number of
  graphs. A capture that fails raises; there is no eager path on the
  card. On the CPU the module runs eagerly: nothing is captured there;
* **warmup** — each bucket runs once at construction (a replay on the
  card), so the first requests pay for nothing lazy;
* **compute dtype** — ``compute_dtype="bfloat16"`` runs the forward in
  bf16 while requests and answers keep their dtypes: floating parameters
  and buffers are cast once at freeze, a floating request is cast on
  entry (inside the captured graph, so the pinned upload stays in the
  request dtype), integer inputs pass through uncast (token ids above 256
  stay exact), and floating outputs come back in the request dtype when
  that is floating, else in float32. The JAX package casts every input,
  ids included, and casts outputs to the request dtype even when that is
  an integer one; the port does neither. :meth:`FrozenModel.quantize`
  with ``mode="bf16"`` freezes such a model.

A graph replays the kernels without running their wrappers, so each
bucket keeps the launches its capture made (``ops.cuda.launch_delta``)
and credits them on every replay (``ops.cuda.add_launch_counts``).

* **random draws** — the JAX ``FrozenModel`` passes the fixed
  ``PRNGKey(0)`` on every call, so a draw in the forward (dropout with
  ``mode="always"``) gives one mask, call after call. Here the model owns
  one ``torch.Generator`` on its device, seeded :data:`FROZEN_SEED`; the
  forward runs inside ``random.using`` of it, so every draw takes it and
  none touches the device's own generator; it is registered with each
  bucket's graph before the capture, and set back to its seed before
  every replay and every eager forward.
* **float16** — ``compute_dtype`` takes float32 and bfloat16, as the
  JAX package's does; a module cast to float16 (``.to(torch.float16)``,
  the JAX ``cast("float16")``) freezes with ``compute_dtype=None`` and
  serves float16 requests or integer ids.
"""
from __future__ import annotations

import copy
import threading
import time

import numpy as np
import torch

from .. import profiler as _prof
from .. import random as _random
from ..context import as_context
from ..ops import cuda as _cuda
from .errors import InvalidInputError

__all__ = ["FrozenModel", "default_buckets", "FROZEN_SEED"]

# the seed of a FrozenModel's generator: the JAX FrozenModel's PRNGKey(0)
FROZEN_SEED = 0


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


def _compute_dtype(name):
    """The ``torch.dtype`` of a ``compute_dtype`` argument, or None."""
    if name is None or str(name) == "float32":
        return None
    if str(name) in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got "
                     f"{name!r}")


class _Graph:
    """One bucket compiled on the card: the captured graph, the static
    input it reads and the static outputs it writes, the kernel launches
    of one replay, and the pinned staging buffer with the event of its
    last upload."""

    __slots__ = ("graph", "x", "outs", "delta", "staging", "uploaded")

    def __init__(self, graph, x, outs, delta, staging):
        self.graph = graph
        self.x = x
        self.outs = outs
        self.delta = delta
        self.staging = staging
        self.uploaded = torch.cuda.Event()


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
        without a card. Pass ``cpu()`` to serve on the CPU. On a card each
        bucket is captured as a CUDA graph here.
    warmup : bool
        Run each bucket once at construction (default True).
    compute_dtype : str, optional
        Run the forward in this dtype ("bfloat16"/"bf16") while requests
        and answers keep theirs (see the module's notes). None/"float32"
        leaves the module as it is.
    """

    def __init__(self, block, input_shape, dtype="float32",
                 batch_buckets=None, ctx=None, warmup=True,
                 compute_dtype=None):
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
        self._compute = _compute_dtype(compute_dtype)
        # floating answers: the request dtype where that is floating
        self._out_dtype = (torch.from_numpy(np.zeros(0, self._dtype)).dtype
                           if self._dtype.kind == "f" else torch.float32)
        self._name = type(block).__name__
        self._block = block
        self._ctx = ctx
        self._module = copy.deepcopy(block).to(self._device).eval()
        if self._compute is not None:
            # once, at freeze: every floating parameter and buffer
            self._module.to(self._compute)
        self._module.requires_grad_(False)
        # every draw of the forward: reset to FROZEN_SEED before each call
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(FROZEN_SEED)
        self._out_tree = None
        # held from a replay to the copy of its outputs to the host
        self._lock = threading.RLock()
        self._graphs = {}
        if self._device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            # largest first: the smaller buckets' captures reuse the
            # memory that the largest one's left free in the shared pool
            for b in reversed(self.buckets):
                self._graphs[b] = self._capture(b, pool)
                _prof.counter("serving.compiles", "serving").increment()
        _prof.set_gauge("serving.compiled_buckets", len(self._graphs),
                        "serving")
        if warmup:
            for b in self.buckets:
                self.run_raw(np.zeros((b,) + self._input_shape, self._dtype))
                self._sync()
                _prof.counter("serving.warmup_runs", "serving").increment()

    def _capture(self, b, pool) -> _Graph:
        """Bucket `b` as a CUDA graph: one eager forward on a side stream,
        then the capture of the forward on a static input; the launches it
        counted are taken back out and kept as one replay's."""
        staging = torch.from_numpy(
            np.zeros((b,) + self._input_shape, self._dtype)).pin_memory()
        # made outside inference mode, so that uploads may write it
        x = staging.to(self._device)

        def forward():
            with torch.inference_mode():
                return self._forward(x)
        # a replay draws from the generator's state at its start, which
        # run_raw sets back to the seed
        graph, leaves, self._out_tree, delta = _cuda.capture(
            forward, self._device, pool, self._gen,
            f"FrozenModel: the forward captured for bucket {b}")
        return _Graph(graph, x, tuple(leaves), delta, staging)

    def _forward(self, x):
        """The module on a device batch in the request dtype, through the
        compute dtype: a floating input is cast on entry, floating outputs
        are cast to the answer dtype on exit, integers pass through. Every
        draw takes the model's generator (set back to its seed by the
        caller)."""
        with _random.using(self._gen):
            if self._compute is None:
                return self._module(x)
            if x.is_floating_point():
                x = x.to(self._compute)
            leaves, tree = _cuda.flatten(self._module(x))
        leaves = [o.to(self._out_dtype) if o.is_floating_point() else o
                  for o in leaves]
        return _cuda.unflatten(tree, leaves)

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
        Does not wait for the device.

        On a card this replays the bucket's graph on the current stream,
        and the tensors returned are the graph's static outputs: the next
        replay overwrites them (of this bucket, or of another, since the
        buckets share one memory pool). Copy them out before the next
        call, as :meth:`predict_batch` does under the model's lock."""
        n = int(x.shape[0])
        if n not in self.buckets:
            raise InvalidInputError(
                f"no bucket for batch {n}; buckets={self.buckets}")
        if tuple(x.shape[1:]) != self._input_shape:
            raise InvalidInputError(
                f"sample shape {tuple(x.shape[1:])} != expected "
                f"{self._input_shape}")
        g = self._graphs.get(n)
        if g is None:
            leaves = self.run_eager(x)
        else:
            with self._lock:
                # the staging buffer is rewritten only once its last
                # upload has left it
                g.uploaded.synchronize()
                # torch's copy splits a large batch over the host's cores
                g.staging.copy_(torch.from_numpy(
                    np.ascontiguousarray(x, dtype=self._dtype)))
                g.x.copy_(g.staging, non_blocking=True)
                g.uploaded.record()
                self._gen.manual_seed(FROZEN_SEED)
                g.graph.replay()
                _cuda.add_launch_counts(g.delta)
                leaves = g.outs
        _prof.counter("serving.executed_batches", "serving").increment()
        return tuple(leaves)

    def run_eager(self, x) -> tuple:
        """The frozen module's forward on the batch `x`, op by op on the
        device with no graph: the CPU's path, and on a card the reference
        a replay is held against. Returns the flat tuple of outputs on the
        device."""
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=self._dtype))
        with self._lock, torch.inference_mode():
            self._gen.manual_seed(FROZEN_SEED)
            leaves, self._out_tree = _cuda.flatten(
                self._forward(xt.to(self._device)))
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
        upload and the device time, and ``unpad_ms`` is the copy back to
        the host."""
        n = int(x.shape[0])
        b = self.bucket_for(n)
        t0 = time.perf_counter()
        if b != n:
            pad = np.zeros((b - n,) + self._input_shape, self._dtype)
            x = np.concatenate([np.ascontiguousarray(x), pad], axis=0)
        t1 = time.perf_counter()
        with self._lock:
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
        return _cuda.unflatten(self._out_tree,
                               [torch.from_numpy(o) for o in outs])

    def quantize(self, mode="int8", **freeze_kwargs):
        """A NEW FrozenModel of the block this one froze, in reduced
        precision; this model serves on unchanged. ``mode="bf16"`` freezes
        with ``compute_dtype="bfloat16"`` (no calibration); buckets and
        ctx default to this model's, `freeze_kwargs` override them. The
        JAX package's ``mode="int8"`` (contrib quantization) is not ported
        yet: ROADMAP's queue of modules to port holds it."""
        kw = {"batch_buckets": self.buckets, "ctx": self._ctx}
        kw.update(freeze_kwargs)
        if mode in ("bf16", "bfloat16"):
            kw.setdefault("compute_dtype", "bfloat16")
            return FrozenModel(self._block, self._input_shape,
                               dtype=self._dtype.name, **kw)
        if mode == "int8":
            raise NotImplementedError(
                "FrozenModel.quantize(mode='int8') is not ported yet (see "
                "ROADMAP.md, A. Modules still to port)")
        raise ValueError(
            f"quantize mode must be 'int8' or 'bf16', got {mode!r}")

    def __repr__(self):
        compute = ("" if self._compute is None else
                   f", compute_dtype={str(self._compute).split('.')[-1]}")
        return (f"FrozenModel({self._name}, input={self._input_shape}, "
                f"dtype={self._dtype.name}{compute}, buckets={self.buckets}, "
                f"device={self._device})")
