"""FusedTrainStep: forward, backward and update of a training step as one
CUDA graph (counterpart of ``incubator_mxnet_tpu/parallel/trainer_step.py``,
on one device).

A step computes what the JAX package's ``step_fn`` does: ``loss =
loss_fn(net(x), y).mean()`` in training mode, the gradients of that mean,
and ``Optimizer.update_fused`` on every parameter that requires grad, with
the optimizer's ``rescale_grad`` and ``clip_gradient``, ``lr * lr_mult``,
``wd * wd_mult`` and the step's own count ``t`` for every parameter.
Buffers such as BatchNorm's moving statistics advance as the forward
writes them (JAX's ``aux_updates``). The optimizer's states belong to the
step (a Trainer passed in gives its optimizer only, as in JAX).

``t``, ``lr`` and ``rescale_grad`` are 0-d f32 tensors on the device
that the step reads; ``t`` advances inside the step, and the host
rewrites the others only when their value changed (JAX's ``_f32``
cache). The weight decay is a number in the step, as ``clip_gradient``
is: a step at wd = 0 runs no ``wd * w`` term, and a graph is captured
for each value of wd the step meets (it has no scheduler). ``__call__``
takes its lr from the host's ``optimizer.learning_rate`` after setting
``num_update``; ``run_k`` runs k steps and takes each one's lr from the
scheduler's closed form (``lr_scheduler.as_torch``) inside the step
where ``schedule_in_program`` is set and the scheduler has one, else
from the host schedule sampled at each of the k counts.

On a CUDA net each input signature ``(x.shape, x.dtype, y.shape,
y.dtype)`` and wd is one CUDA graph, all in one memory pool (the
counterpart of ``jax.jit``'s cache; counted in ``fused_step.captures``),
built as ``serving.FrozenModel`` builds a bucket: one forward and
backward on a side stream with no update (it builds the kernels and
fills what a first call fills; the moving statistics it moves are put
back), every gradient set to None, then the capture of the whole step
under ``ops.cuda.launch_delta``. The gradients the capture allocates are static
buffers that every replay rewrites (``grad_req="write"`` with no graph
walk). A step is one replay: the batch is copied into the static inputs,
the graph replays, and the launches the capture counted are credited. It
reads nothing back to the host: the loss stays on the device. A capture
that fails raises; no step falls back to running op by op. A CPU net runs
the same step function eagerly (the caller asked for the CPU).

Dropout in a step draws fresh masks on every step, as the JAX package's
fresh key a call does: the device's seeded generator (``random``) is
registered with every graph the step captures, so each replay draws from
the generator's offset and advances it, and ``random.seed`` after a
capture re-seeds what the next replays draw. A capture that cannot
register the generator raises, and one that draws from another CUDA
generator (a ``Dropout(generator=)``) raises in PyTorch. SGLD has no
fused update (``Optimizer.supports_fused``): the step refuses it, as the
JAX package's does.

Not ported: ``mesh``, ``data_axis``, ``sharding``,
``shard_optimizer_states``, ``remat`` and ``remat_policy`` (ROADMAP
A.10), and the resilience, devicescope and memscope hooks (A.11). There
is no loss scaler, as in JAX's fused step.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd, profiler
from .. import random as _random
from .. import optimizer as opt_mod
from ..gluon.trainer import Trainer
from ..ndarray import NDArray, _has_nd, _unwrap, _wrap
from ..ops import cuda as _cuda

__all__ = ["FusedTrainStep"]

# the JAX package's arguments the port takes only at their defaults, and
# the ROADMAP item (queue A) that ports each
_LATER = {"mesh": "A.10", "data_axis": "A.10", "sharding": "A.10",
          "shard_optimizer_states": "A.10", "remat": "A.10",
          "remat_policy": "A.10", "prefetch_depth": "A.8",
          "io_workers": "A.8", "io_transform": "A.8", "resilience": "A.11"}


def refuse_unported(where, **given):
    """Raise NotImplementedError for an argument of `given` that is set
    (not None or False): its port has not been written yet."""
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet: ROADMAP.md, A. "
                f"Modules still to port, item {_LATER[name]}")


def as_tensor(a):
    """A batch as a tensor: an NDArray's, a numpy array through
    ``torch.from_numpy``."""
    a = _unwrap(a)
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def to_device(a, device):
    """`a` on `device`: a host tensor bound for a card is uploaded from
    pinned memory without waiting (nothing is read back)."""
    if a.device == device:
        return a
    if device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a.to(device)


def _listed(seq):
    """A list of batches as it is; one stacked array as a 1-tuple."""
    return seq if isinstance(seq, (list, tuple)) else (seq,)


def stack(seq):
    """A (k, ...) tensor from a stacked array or tensor, or from a list of
    k batches (numpy arrays stacked on the host)."""
    if isinstance(seq, (list, tuple)):
        if all(isinstance(b, (torch.Tensor, NDArray)) for b in seq):
            return torch.stack([as_tensor(b) for b in seq])
        return torch.from_numpy(np.stack([np.asarray(b) for b in seq]))
    return as_tensor(seq)


class _Graph:
    """One input signature captured on the card: the graph, the static
    inputs it reads, the loss and lr it writes, the gradient buffers it
    owns (held here so no other capture takes their memory), and the
    kernel launches of one replay."""

    __slots__ = ("graph", "x", "y", "loss", "lr", "grads", "delta")

    def __init__(self, graph, x, y, loss, lr, grads, delta):
        self.graph, self.x, self.y = graph, x, y
        self.loss, self.lr, self.grads, self.delta = loss, lr, grads, delta


class FusedTrainStep:
    """Forward, backward and update in one step (one CUDA graph on a
    card)::

        step = FusedTrainStep(net, loss_fn, "sgd")   # or an Optimizer or
        loss = step(x, y)                            # a gluon.Trainer
        losses = step.run_k(xs, ys)                  # k steps, (k,) losses
    """

    def __init__(self, net, loss_fn, optimizer, schedule_in_program=False,
                 mesh=None, data_axis=None, sharding=None,
                 shard_optimizer_states=False, remat=False,
                 remat_policy=None):
        refuse_unported("FusedTrainStep", mesh=mesh, data_axis=data_axis,
                        sharding=sharding,
                        shard_optimizer_states=shard_optimizer_states,
                        remat=remat, remat_policy=remat_policy)
        self.net = net
        self.loss_fn = loss_fn
        if isinstance(optimizer, Trainer):
            self.optimizer = optimizer.optimizer
        elif isinstance(optimizer, str):
            self.optimizer = opt_mod.create(optimizer)
        else:
            self.optimizer = optimizer
        self.schedule_in_program = schedule_in_program
        first = next(iter(net.parameters()), None)
        if first is None:
            raise ValueError("FusedTrainStep: the net has no parameters")
        self.device = first.device
        self._num_update = 0
        self.params = None      # resolved at the first call
        self._states = None
        self._lr_program = None
        self._graphs = {}
        # the lr each step of the last run_k used, (k,) on the device
        self.last_lrs = None

    # -- setup ------------------------------------------------------------
    def _resolve(self):
        """The trainable parameters, their multipliers and packed states,
        the device scalars the step reads, and the lr's closed form."""
        opt = self.optimizer
        if not opt.supports_fused():
            raise NotImplementedError(
                f"FusedTrainStep: {type(opt).__name__} has no fused update "
                f"(it keeps the per-parameter path, as in the JAX "
                f"package); train it through gluon.Trainer")
        self.params = [p for p in self.net.parameters() if p.requires_grad]
        self.lr_mults = [getattr(p, "lr_mult", 1.0) for p in self.params]
        self.wd_mults = [getattr(p, "wd_mult", 1.0) for p in self.params]
        self._states = opt_mod.pack_states(
            [opt.create_state_multi_precision(i, p)
             for i, p in enumerate(self.params)])
        sched = getattr(opt, "lr_scheduler", None)
        if self.schedule_in_program and sched is not None:
            self._lr_program = sched.as_torch()
        self._t = self._scalar(self._num_update)
        self._in_program = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
        self._in_program_now = False
        self._hyper = {name: [None, self._scalar(0.0)]
                       for name in ("lr", "rescale")}
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()

    def _scalar(self, v):
        # filled on the device: no upload from pageable host memory
        return torch.zeros((), dtype=torch.float32,
                           device=self.device).fill_(float(v))

    def _set(self, name, v):
        """Write hyperparameter `name` into its device scalar, only when
        its value changed."""
        v = float(v)
        slot = self._hyper[name]
        if slot[0] != v:
            slot[1].fill_(v)
            slot[0] = v

    def _set_hypers(self, in_program):
        opt = self.optimizer
        self._set("rescale", opt.rescale_grad)
        if self._in_program_now != in_program:
            self._in_program.fill_(in_program)
            self._in_program_now = in_program

    def _step(self, x, y):
        """One step on the device batch `x`, `y`: the function a graph
        captures. Returns the loss and the lr used, 0-d tensors."""
        t = self._t
        t.add_(1.0)
        lr = self._hyper["lr"][1]
        if self._lr_program is not None:
            lr = torch.where(self._in_program, self._lr_program(t), lr)
        for p in self.params:
            p.grad = None
        with autograd.record():
            loss = self.loss_fn(self.net(x), y).mean()
        torch.autograd.backward(loss)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        self.optimizer.update_fused(
            self.params, grads, self._states, lr, float(self.optimizer.wd),
            t, self.lr_mults, self.wd_mults,
            rescale=self._hyper["rescale"][1])
        return loss.detach(), lr

    def _capture(self, x, y):
        """The step for `x`'s and `y`'s signature as a CUDA graph."""
        device = self.device
        sx = torch.empty(x.shape, dtype=x.dtype, device=device)
        sy = torch.empty(y.shape, dtype=y.dtype, device=device)
        sx.copy_(x)
        sy.copy_(y)
        buffers = list(self.net.buffers())
        saved = [b.clone() for b in buffers]

        def warmup():
            with autograd.record():
                loss = self.loss_fn(self.net(sx), sy).mean()
            torch.autograd.backward(loss)
            del loss
            if self._lr_program is not None:
                self._lr_program(self._t)
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
            for p in self.params:
                p.grad = None
        graph, (loss, lr), _, delta = _cuda.capture(
            lambda: self._step(sx, sy), device, self._pool,
            _random.generator(device),
            f"FusedTrainStep: the step captured for {tuple(x.shape)}",
            warmup=warmup)
        profiler.counter("fused_step.captures").increment()
        return _Graph(graph, sx, sy, loss, lr,
                      [p.grad for p in self.params], delta)

    def _graph_for(self, x, y):
        """Resolve at the first call; on a card, the graph of this
        signature and weight decay (captured at its first call), else
        None."""
        if self.params is None:
            self._resolve()
        if self.device.type != "cuda":
            return None
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               float(self.optimizer.wd))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(x, y)
        return g

    def ensure_built(self, x, y):
        """Resolve the parameters and states and capture the step for
        this signature, without spending an update. Returns self."""
        self._graph_for(as_tensor(x), as_tensor(y))
        return self

    def _run(self, g, x, y):
        """One step: a replay of `g` (its launches credited), or on the
        CPU the step function. Returns the loss and lr tensors (a graph's
        are its static outputs)."""
        if g is None:
            return self._step(to_device(x, self.device),
                              to_device(y, self.device))
        g.x.copy_(x if x.device == self.device else x.pin_memory(),
                  non_blocking=True)
        g.y.copy_(y if y.device == self.device else y.pin_memory(),
                  non_blocking=True)
        g.graph.replay()
        _cuda.add_launch_counts(g.delta)
        return g.loss, g.lr

    # -- execution --------------------------------------------------------
    def __call__(self, x, y):
        """One step; returns its mean loss, a 0-d tensor on the device (an
        NDArray when `x` or `y` is one)."""
        if _has_nd((x, y)):
            return _wrap(self(as_tensor(x), as_tensor(y)))
        x, y = as_tensor(x), as_tensor(y)
        g = self._graph_for(x, y)
        self._num_update += 1
        self.optimizer.num_update = self._num_update
        self._set("lr", self.optimizer.learning_rate)
        self._set_hypers(False)
        loss, _ = self._run(g, x, y)
        profiler.set_gauge("trainer.dispatches_per_step", 1)
        return loss if g is None else loss.clone()

    def _chunk_lrs(self, k):
        """The host schedule at the next k counts (the scheduler advances
        as a sequential loop's would)."""
        opt = self.optimizer
        if getattr(opt, "lr_scheduler", None) is None:
            return [float(opt.learning_rate)] * k
        out = []
        for i in range(k):
            opt.num_update = self._num_update + 1 + i
            out.append(float(opt.learning_rate))
        return out

    def run_k(self, xs, ys):
        """k steps, one replay each, on stacked (k, batch, ...) inputs (or
        lists of k batches). Each step's lr comes from the closed form on
        the device when ``schedule_in_program`` found one, else from the
        host schedule at its count. Returns the k losses, a (k,) tensor on
        the device (an NDArray when the inputs are NDArrays);
        ``last_lrs`` holds the k lrs used."""
        if _has_nd((*_listed(xs), *_listed(ys))):
            return _wrap(self.run_k(stack(xs), stack(ys)))
        xs, ys = stack(xs), stack(ys)
        k = int(xs.shape[0])
        g = self._graph_for(xs[0], ys[0])
        in_program = self._lr_program is not None
        lrs = None if in_program else self._chunk_lrs(k)
        self._set_hypers(in_program)
        xs, ys = to_device(xs, self.device), to_device(ys, self.device)
        losses = None
        used = torch.empty(k, dtype=torch.float32, device=self.device)
        for i in range(k):
            if lrs is not None:
                self._set("lr", lrs[i])
            loss, lr = self._run(g, xs[i], ys[i])
            if losses is None:
                losses = torch.empty(k, dtype=loss.dtype, device=self.device)
            losses[i].copy_(loss)
            used[i].copy_(lr)
        self._num_update += k
        self.optimizer.num_update = self._num_update
        self.last_lrs = used
        profiler.set_gauge("trainer.dispatches_per_step", round(1.0 / k, 4))
        return losses
