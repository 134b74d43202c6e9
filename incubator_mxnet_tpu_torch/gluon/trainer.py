"""gluon.Trainer for one device (counterpart of
``incubator_mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` = ``allreduce_grads()`` (nothing to reduce on one
device) + ``update``: the optimizer's rule on every parameter with
``rescale_grad = _scale / batch_size``, all parameters in one
``Optimizer.update_multi`` call (multi-tensor ops). ``_scale`` is 1 unless
``amp.init_trainer`` sets it to the inverse loss scale for a step (a 0-d
tensor on the parameters' device under a dynamic scaler), together with
``_amp_skip``, the on-device overflow flag the update selects on. States
are created by ``Optimizer.create_state_multi_precision`` (a bf16 weight
under ``multi_precision`` gets an f32 master) and packed into one buffer
(``optimizer.pack_states``), so that an overflowed step's select is one
launch.

MXNet's default ``grad_req="write"`` overwrites a gradient on every
backward; PyTorch accumulates into ``.grad``. So after its update the
Trainer sets every gradient it applied to None, and the next backward
writes afresh; a ``grad_req="add"`` gradient is kept (it sums until
``zero_grad``). A parameter that got no gradient since the last update
raises, unless ``ignore_stale_grad=True`` skips it. Given a
``ParameterDict`` (``net.collect_params()``), the Trainer takes its
parameters in sorted key order, as the JAX Trainer orders a dict, and
leaves out the ``grad_req="null"`` ones.

``save_states``/``load_states`` keep the JAX package's file: a pickle
(protocol 4) of ``num_update``, ``index_update_count`` and the states as
tuples of numpy arrays (masters first), so a file written by either
package loads into the other. ``loop_chunk=`` marks the Trainer for
``TrainLoop`` as in the JAX package.

Not ported: the kvstore and ``update_on_kvstore``, gradient compression,
the overlapped gradient scheduler, the ``fused_update`` switch (the
update is always multi-tensor), and the ``sharding`` and ``resilience``
markers (ROADMAP A.10 and A.11).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import optimizer as opt_mod
from .. import profiler
from .parameter import ParameterDict

__all__ = ["Trainer"]


def _collect(params):
    """A module's parameters, a ParameterDict's or a dict's values in
    sorted key order (as the JAX Trainer orders a dict; a ParameterDict's
    ``grad_req="null"`` parameters left out), or an iterable's items; each
    once, as tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, ParameterDict):
        params = [params[k]._var for k in sorted(params)
                  if params[k].grad_req != "null"]
    elif isinstance(params, dict):
        params = [params[k] for k in sorted(params)]
    out, seen = [], set()
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


class Trainer:
    """Applies `optimizer` (a name for ``optimizer.create`` with
    `optimizer_params`, or an ``Optimizer``) to `params`: a module, a
    ``ParameterDict``, an iterable of parameters, or a dict of named
    parameters. Parameters that
    do not require grad are left alone. `loop_chunk` is the chunk that a
    ``TrainLoop`` built on this Trainer runs (the step itself ignores
    it)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 loop_chunk=None):
        self.loop_chunk = int(loop_chunk) if loop_chunk else None
        self._params = [p for p in _collect(params) if p.requires_grad]
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._states = [None] * len(self._params)
        self._scale = 1.0
        self._amp_skip = None

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Aggregate gradients across devices: nothing to do on one."""

    def step(self, batch_size, ignore_stale_grad=False):
        """``allreduce_grads()`` then the update, with gradients rescaled by
        ``_scale`` / `batch_size`."""
        self._optimizer.rescale_grad = self._scale / batch_size
        profiler.counter("trainer.steps").increment()
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone (after an explicit ``allreduce_grads()``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad):
        stale = [i for i, p in enumerate(self._params) if p.grad is None]
        if stale and not ignore_stale_grad:
            raise RuntimeError(
                f"{len(stale)} parameter(s) got no gradient since the last "
                f"update (indices {stale[:8]}); run a backward first, or "
                f"pass ignore_stale_grad=True to skip them")
        opt = self._optimizer
        live = [i for i, p in enumerate(self._params) if p.grad is not None]
        fresh = [i for i in live if self._states[i] is None]
        for i in fresh:
            self._states[i] = opt.create_state_multi_precision(
                i, self._params[i])
        if fresh:
            self._states = opt_mod.pack_states(self._states)
        params = [self._params[i] for i in live]
        states = opt.update_multi(live, params, [p.grad for p in params],
                                  [self._states[i] for i in live],
                                  skip=self._amp_skip)
        for i, p, s in zip(live, params, states):
            self._states[i] = s
            if getattr(p, "grad_req", "write") != "add":
                p.grad = None

    # -- persistence ------------------------------------------------------
    def save_states(self, fname):
        """Write the update counts and every state (tuples of numpy
        arrays, None for a parameter not updated yet) to `fname`."""
        opt = self._optimizer
        blob = {"num_update": opt.num_update,
                "index_update_count": dict(opt._index_update_count),
                "states": [None if s is None else
                           tuple(t.detach().cpu().numpy() for t in s)
                           for s in self._states]}
        with open(fname, "wb") as f:
            pickle.dump(blob, f, protocol=4)

    def load_states(self, fname):
        """Read what :meth:`save_states` (of either package) wrote: the
        update counts, and the states onto each parameter's device, packed
        into one buffer (a master keeps f32)."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        if len(blob["states"]) != len(self._params):
            raise ValueError(f"load_states: {len(blob['states'])} states for "
                             f"{len(self._params)} parameters")
        opt = self._optimizer
        opt.num_update = blob["num_update"]
        opt._index_update_count = dict(blob.get("index_update_count", {}))
        self._states = opt_mod.pack_states([
            None if s is None else tuple(
                torch.from_numpy(np.array(a, np.float32)).to(p.device)
                for a in s)
            for p, s in zip(self._params, blob["states"])])
