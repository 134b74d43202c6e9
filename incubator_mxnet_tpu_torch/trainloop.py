"""TrainLoop: a run of training steps in chunks of k (counterpart of
``incubator_mxnet_tpu/trainloop.py``, on one device).

``run_chunk(xs, ys)`` runs k steps through ``FusedTrainStep.run_k``: k
replays of the step's CUDA graph on a card, each step's lr computed on the
device from its count when the scheduler has a closed form
(``schedule_in_program``, on by default), else taken from the host
schedule. The losses stay on the device. ``fit`` drives a data source
through whole chunks: each chunk's k batches are stacked on the host and
uploaded once, from pinned memory, and the losses are fetched once, at
the end.

Telemetry: the counters ``trainloop/trainloop.chunks`` and
``trainloop/trainloop.steps``, the gauges ``trainloop.k``,
``trainloop.chunk_ms`` (the host's time inside a chunk's dispatch) and
``trainloop.in_program_lr``, beside the step's
``mxtpu/trainer.dispatches_per_step`` (1/k).

Not ported: the chunk's environment layers (``MXTPU_LOOP_CHUNK`` and the
autotune winner, with the knob table, ROADMAP A.11), the device
prefetcher and its decode pool (``prefetch_depth``, ``io_workers``,
``io_transform``, A.8), ``fit(resilience=)`` (A.11), and the step's mesh,
sharding and remat arguments (A.10).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import profiler
from .ndarray import NDArray
from .parallel.trainer_step import (FusedTrainStep, as_tensor,
                                    refuse_unported, stack, to_device)

__all__ = ["TrainLoop", "resolve_chunk"]


def resolve_chunk(explicit=None, optimizer=None, default=4):
    """The chunk: an explicit one, else the Trainer's ``loop_chunk``, else
    `default`."""
    if explicit:
        return int(explicit)
    lc = getattr(optimizer, "loop_chunk", None)
    if lc:
        return int(lc)
    return int(default)


def _split_batch(b):
    """One source item as (x, y): a batch object with ``data`` (and
    ``label``) lists, an (x, y) pair, or a bare array (no label)."""
    data = getattr(b, "data", None)
    if data is not None and not isinstance(b, (tuple, list, np.ndarray,
                                               torch.Tensor, NDArray)):
        label = getattr(b, "label", None)
        return data[0], (label[0] if label else None)
    if isinstance(b, (tuple, list)) and len(b) == 2:
        return b[0], b[1]
    return b, None


def _batches(data, cycle, skip):
    """The items of `data`, the first `skip` dropped. With `cycle` a
    source that ends starts again: an object with ``reset()`` is reset, a
    re-iterable is iterated anew, a bare iterator ends the stream. A skip
    longer than an epoch of a cycled source folds whole epochs away."""
    epoch_len = None
    while True:
        n = 0
        for b in data:
            n += 1
            if skip > 0:
                if cycle and epoch_len:
                    skip %= epoch_len
                if skip > 0:
                    skip -= 1
                    continue
            yield b
        if n and epoch_len is None:
            epoch_len = n
        if not cycle:
            return
        if hasattr(data, "reset"):
            data.reset()
        elif iter(data) is data:
            return


class TrainLoop:
    """Runs a ``FusedTrainStep`` chunk by chunk::

        loop = TrainLoop(net, loss_fn, trainer)     # or an optimizer
        losses = loop.fit(batches, steps=500)       # numpy (500,)
        losses = loop.run_chunk(xs, ys)             # (k,), on the device

    ``chunk`` defaults to the Trainer's ``loop_chunk``, else 4."""

    def __init__(self, net, loss_fn, optimizer, chunk=None,
                 schedule_in_program=True, mesh=None, data_axis=None,
                 sharding=None, remat=False, remat_policy=None,
                 prefetch_depth=None, io_workers=None, io_transform=None):
        refuse_unported("TrainLoop", prefetch_depth=prefetch_depth,
                        io_workers=io_workers, io_transform=io_transform)
        self.chunk = resolve_chunk(explicit=chunk, optimizer=optimizer)
        if self.chunk < 1:
            raise ValueError(f"loop chunk must be >= 1, got {self.chunk}")
        self.step = FusedTrainStep(
            net, loss_fn, optimizer, schedule_in_program=schedule_in_program,
            mesh=mesh, data_axis=data_axis, sharding=sharding, remat=remat,
            remat_policy=remat_policy)

    @property
    def net(self):
        return self.step.net

    @property
    def optimizer(self):
        return self.step.optimizer

    @property
    def num_update(self):
        return self.step._num_update

    @property
    def in_program_lr(self) -> bool:
        """True once the step computes its lr on the device from its count
        (a closed-form scheduler); False: the host schedule."""
        return self.step._lr_program is not None

    def run_chunk(self, xs, ys):
        """k steps on stacked (k, batch, ...) inputs (or lists of k
        batches), NDArrays or tensors; returns the k losses, still on the
        device, in the inputs' kind."""
        t0 = time.perf_counter()
        losses = self.step.run_k(xs, ys)
        k = int(losses.shape[0])
        profiler.counter("trainloop.chunks", "trainloop").increment()
        profiler.counter("trainloop.steps", "trainloop").increment(k)
        profiler.set_gauge("trainloop.k", k, "trainloop")
        profiler.set_gauge("trainloop.chunk_ms",
                           round((time.perf_counter() - t0) * 1e3, 3),
                           "trainloop")
        profiler.set_gauge("trainloop.in_program_lr",
                           int(self.in_program_lr), "trainloop")
        return losses

    def _stacked(self, items):
        """A chunk's (x, y) items as two (k, ...) tensors on the step's
        device: stacked on the host, uploaded once."""
        xs = stack([x for x, _ in items])
        labelled = [y is not None for _, y in items]
        if not any(labelled):
            raise ValueError(
                "TrainLoop.fit needs labeled batches ((x, y) pairs or "
                "batches with labels); got a label-less batch: for "
                "self-supervised inputs yield (x, x)")
        if not all(labelled):
            raise ValueError(
                f"mixed labeled/label-less batches in one chunk "
                f"({sum(labelled)}/{len(items)} labeled)")
        ys = stack([y for _, y in items])
        device = self.step.device
        return to_device(xs, device), to_device(ys, device)

    def _chunks_of(self, data, cycle, skip):
        items = []
        for b in _batches(data, cycle, skip):
            items.append(_split_batch(b))
            if len(items) == self.chunk:
                yield self._stacked(items)
                items = []
        # a partial chunk at the end is dropped: one graph, one shape

    def fit(self, data, steps=None, epochs=None, cycle=None, skip_batches=0,
            resilience=None):
        """Train on `data`: an iterable of (x, y) pairs (numpy arrays,
        NDArrays or tensors), or an object with ``reset()`` as well.

        steps : optimizer steps to run, rounded down to whole chunks; the
                source is cycled across its ends unless `cycle` is False.
        epochs: passes over the source instead; an object with ``reset()``
                is reset at each one, and each epoch's partial chunk is
                dropped.
        skip_batches : source batches to drop before training.

        Returns the losses of every step as a numpy array, fetched from
        the device once at the end."""
        refuse_unported("TrainLoop.fit", resilience=resilience)
        if (steps is None) == (epochs is None):
            raise ValueError("pass exactly one of steps= or epochs=")
        histories = []
        if steps is not None:
            n_chunks = steps // self.chunk
            if n_chunks < 1:
                raise ValueError(
                    f"steps={steps} is less than one chunk of "
                    f"{self.chunk}; lower the chunk or raise steps")
            chunks = self._chunks_of(data, True if cycle is None else cycle,
                                     skip_batches)
            for i in range(n_chunks):
                try:
                    xs, ys = next(chunks)
                except StopIteration:
                    raise ValueError(
                        f"data source exhausted after {i * self.chunk} of "
                        f"{steps} steps and cannot be rewound (pass a "
                        f"re-iterable or an object with reset(), or lower "
                        f"steps=)") from None
                histories.append(self.run_chunk(xs, ys))
        else:
            for e in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                n_before = len(histories)
                for xs, ys in self._chunks_of(
                        data, False, skip_batches if e == 0 else 0):
                    histories.append(self.run_chunk(xs, ys))
                if len(histories) == n_before:
                    raise ValueError(
                        f"epoch {e + 1} produced no chunks: the source is "
                        f"exhausted or cannot be rewound, or yields fewer "
                        f"than chunk={self.chunk} batches")
        if not histories:
            return np.zeros((0,), np.float32)
        return torch.cat([as_tensor(h) for h in histories]).float().cpu(
        ).numpy()
