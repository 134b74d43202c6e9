"""Block and HybridBlock (counterpart of ``incubator_mxnet_tpu/gluon/
block.py``; parity: python/mxnet/gluon/block.py).

A :class:`Block` is a ``torch.nn.Module``: its parameters are module
parameters and buffers, its children submodules, so ``state_dict``,
``.to()``, ``FusedTrainStep``, ``FrozenModel`` and the optimizers take it
as they take any module, and ``register_forward_hook`` and ``apply`` are
PyTorch's (their signatures are MXNet's). What it adds is MXNet's:

- names: a prefix from :class:`NameManager` (``dense_0``, then
  ``dense_0weight`` for its parameter), ``params`` (the block's own
  :class:`~.parameter.ParameterDict`), ``collect_params(select=)`` (the
  subtree's parameters by full name, filtered by a regular expression)
  and ``name_scope()`` (a no-op, as in the JAX package);
- ``initialize(init, ctx)``, ``cast(dtype)``, and deferred shapes: a layer
  declares a parameter with 0s where the JAX layer infers a size, and its
  first call completes the shapes (``infer_shape``) and draws them;
- ``save_parameters``/``load_parameters`` by structural name
  (``features.0.weight``, the JAX package's ``_collect_params_with_
  prefix``) in the JAX package's file, so either package reads the
  other's; loading completes deferred shapes.

:class:`HybridBlock` adds ``hybridize()``. On the card, a call outside
``autograd.record()`` with tensor arguments runs from one CUDA graph per
input signature (shapes, dtypes, device, training mode): the first call of
a signature runs one eager forward on a side stream, then captures the
forward with ``ops.cuda.capture``, as ``FrozenModel`` captures a bucket,
and every call copies its arguments into the graph's static inputs,
replays, credits the kernel launches the capture counted and returns
copies of the static outputs. Copies and pickles of a block leave its
graphs behind (a copy captures its own). A
call under ``record()`` runs op by op: the compiled training step is
``parallel.FusedTrainStep``'s graph. So does a call inside another
capture (``FrozenModel``'s, an outer block's). On the CPU ``hybridize``
changes nothing. The graphs read the parameters' storage in place:
``set_data``, ``load_parameters`` and ``initialize`` copy into it, and
whatever gives a parameter new storage (``cast``, ``.to()``) bumps
``parameter.storage_epoch``, which drops the cache.

A block called with NDArrays (``nd``) runs its forward on their tensors
and returns NDArrays (a tuple of them where the forward returns a tuple);
called with tensors it returns tensors. A hybridized block called with
NDArrays takes the CUDA-graph path as it does with tensors.

Not ported: ``SymbolBlock``, ``export`` and ``imports`` (ROADMAP A.9) and
``shard`` (ROADMAP A.10); each raises.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import torch

from .. import autograd
from .. import random as _random
from ..context import as_context
from ..ndarray import _has_nd, _unwrap, _wrap_out
from ..ops import cuda as _cuda
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _dtype_name, _torch_dtype,
                        bump_storage_epoch, load_arrays, save_arrays,
                        storage_epoch)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "NameManager",
           "camel_to_snake"]


class NameManager:
    """Unique names per prefix hint, counted per thread (parity:
    mx.name.NameManager as the JAX package keeps it)."""

    _tls = threading.local()

    def __init__(self):
        self._counts = {}

    def get(self, name, hint):
        if name is not None:
            return name
        idx = self._counts.get(hint, 0)
        self._counts[hint] = idx + 1
        return f"{hint}{idx}"

    @classmethod
    def current(cls):
        if not hasattr(cls._tls, "nm"):
            cls._tls.nm = NameManager()
        return cls._tls.nm

    @classmethod
    def reset(cls):
        """A fresh count in this thread (names start at 0 again)."""
        cls._tls.nm = NameManager()


# "LSTMCell" -> "lstm_cell", "Conv2D" -> "conv2d", "HybridSequential" ->
# "hybrid_sequential": split at lower-to-upper and acronym-to-word
# boundaries only; digits do not split
_SNAKE_RE = re.compile(r"(?<=[a-z])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def camel_to_snake(name: str) -> str:
    return _SNAKE_RE.sub("_", name).lower()


class _NameScope:
    """``with self.name_scope():`` for parity: naming is automatic."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _call_nd(call, args, kwargs):
    """`call` on the tensors of NDArray arguments, its outputs wrapped."""
    return _wrap_out(call(*[_unwrap(a) for a in args],
                          **{k: _unwrap(v) for k, v in kwargs.items()}))


class Block(torch.nn.Module):
    def __init__(self, prefix=None, params=None):
        super().__init__()
        hint = camel_to_snake(type(self).__name__) + "_"
        self._prefix = NameManager.current().get(prefix, hint)
        self._params = ParameterDict(self._prefix)
        if params is not None:
            self._params.update(params.items() if isinstance(
                params, ParameterDict) else params)
        self._reg_params = OrderedDict()
        self._pending = False       # own parameters wait for a shape

    # -- registration -----------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value._bind(self, name)
            self.__dict__.get("_reg_params", {})[name] = value
            if value._buffer:
                self.register_buffer(name, value._var)
            else:
                super().__setattr__(name, value._var)
            if value._lazy:
                self.__dict__["_pending"] = True
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def _blocks(self):
        return [m for m in self._modules.values() if isinstance(m, Block)]

    # -- properties -------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return _NameScope()

    # -- parameter collection --------------------------------------------
    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its descendants' parameters by full name; with
        `select`, those whose names the regular expression finds."""
        out = ParameterDict(self._prefix)
        out.update({p.name: p for p in self._params.values()})
        out.update({p.name: p for p in self._reg_params.values()})
        for child in self._blocks():
            out.update(child.collect_params().items())
        if select is None:
            return out
        pat = re.compile(select)
        selected = ParameterDict(self._prefix)
        selected.update((k, v) for k, v in out.items() if pat.search(k))
        return selected

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the subtree on `ctx` (default
        ``gpu(0)``, which raises without a card): a parameter's own
        initializer wins over `init`; deferred shapes wait for the first
        call."""
        self.collect_params().initialize(init=init, ctx=ctx, verbose=verbose,
                                         force_reinit=force_reinit)

    def cast(self, dtype):
        """Store every parameter and buffer of the subtree in `dtype` (the
        JAX package's ``cast``; ``module.to(dtype)`` with the parameters'
        dtype names kept)."""
        self.to(_torch_dtype(dtype))
        for p in self.collect_params().values():
            p.dtype = _dtype_name(dtype)
        return self

    def _apply(self, fn, recurse=True):
        # .to(), .cuda(), .half(): parameters get new storage (and buffers
        # new tensors), which a captured graph must not read
        out = super()._apply(fn, recurse)
        bump_storage_epoch()
        for p in self._reg_params.values():
            if not p._lazy:
                p.dtype = _dtype_name(p._var.dtype)
                p._tag()
        return out

    def shard(self, *args, **kwargs):
        raise NotImplementedError(
            "Block.shard (sharding annotations for a mesh) is not ported "
            "yet (ROADMAP A.10)")

    # -- persistence ------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """Structural names (``features.0.weight``), independent of the
        name counters: what save and load match."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Every initialized parameter by structural name, in the JAX
        package's file (``nd.save``); `deduplicate` keeps one name of a
        shared parameter."""
        arrays, seen = {}, set()
        for name, p in self._collect_params_with_prefix().items():
            if p._lazy or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            arrays[name] = p._tensor_checked()
        save_arrays(filename, arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Read a file of :meth:`save_parameters` (of either package) by
        structural name, or, where no name matches, by full name; each
        value goes into its parameter's storage (a deferred one takes the
        value's shape on `ctx`, default the device ``initialize`` named, or
        the CPU)."""
        arrays = load_arrays(filename)
        params = self._collect_params_with_prefix()
        if arrays and not any(k in params for k in arrays):
            self.collect_params().load(filename, ctx=ctx,
                                       allow_missing=allow_missing,
                                       ignore_extra=ignore_extra)
            return
        device = None if ctx is None else as_context(ctx).device
        for name, p in params.items():
            if name in arrays:
                p._set_data(arrays[name], device)
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing from {filename}")
        if not ignore_extra:
            extra = set(arrays) - set(params)
            if extra:
                raise KeyError(f"File {filename} has extra parameters "
                               f"{sorted(extra)}")

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # a deferred parameter takes its shape from the state dict first
        for name, p in self._reg_params.items():
            key = prefix + name
            if p._lazy and key in state_dict:
                p._set_data(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)

    # -- execution --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _call_nd(self.__call__, args, kwargs)
        if self._pending:
            self._deferred_infer(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def _deferred_infer(self, *args, **kwargs):
        """Complete this block's deferred shapes from the inputs
        (``infer_shape``) and draw them."""
        lazy = [p for p in self._reg_params.values() if p._lazy]
        if lazy:
            self.infer_shape(*args, **kwargs)
            for p in lazy:
                p.finish_deferred_init()
        self._pending = False

    def infer_shape(self, *args, **kwargs):
        """Layers with deferred parameters set their shapes here from the
        first call's inputs."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has uninitialized parameters and no "
            f"infer_shape; give its shapes explicitly")

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        lines = [f"{type(self).__name__}("]
        for name, child in self._modules.items():
            lines.append(f"  ({name}): {type(child).__name__}")
        lines.append(")")
        return "\n".join(lines)


_CAPTURING = threading.local()


def _on_card(args):
    """Whether a call on `args` takes the CUDA-graph path's device."""
    return args[0].device.type == "cuda"


class _Graph:
    """One input signature captured: the graph, its static inputs and
    outputs, the output tree, the kernel launches of one replay and the
    storage epoch it was captured at."""

    __slots__ = ("graph", "inputs", "outputs", "tree", "delta", "epoch")

    def __init__(self, graph, inputs, outputs, tree, delta, epoch):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.tree, self.delta, self.epoch = tree, delta, epoch


class HybridBlock(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._graphs = {}
        self._pool = None
        self.captures = 0           # CUDA graphs captured (all signatures)

    # copies and pickles (FrozenModel deep-copies its block) leave the
    # graphs behind: a CUDA graph cannot be copied, and a copy's graphs
    # would read the original's storage
    def __getstate__(self):
        state = super().__getstate__()
        state.update(_graphs={}, _pool=None, captures=0)
        return state

    def hybridize(self, active=True, **kwargs):
        """Turn the CUDA-graph path on (or off) here and in every hybrid
        descendant; drops the graphs captured so far."""
        self._active = bool(active)
        self._graphs = {}
        for child in self._blocks():
            if isinstance(child, HybridBlock):
                child.hybridize(active, **kwargs)

    def __call__(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _call_nd(self.__call__, args, kwargs)
        if (self._active and not kwargs and args
                and not getattr(_CAPTURING, "on", False)
                and not autograd.is_recording()
                and all(isinstance(a, torch.Tensor) for a in args)
                and _on_card(args)
                and not torch.cuda.is_current_stream_capturing()):
            return self._call_cached(*args)
        return super().__call__(*args, **kwargs)

    def _call_cached(self, *args):
        key = (tuple((tuple(a.shape), a.dtype, a.device) for a in args),
               autograd.is_training())
        g = self._graphs.get(key)
        if g is not None and g.epoch != storage_epoch():
            self._graphs = {}
            g = None
        if g is None:
            if any(p._lazy for p in self.collect_params().values()):
                # the call that completes deferred shapes runs eagerly
                return Block.__call__(self, *args)
            g = self._graphs[key] = self._capture(args)
        for s, a in zip(g.inputs, args):
            s.copy_(a)
        g.graph.replay()
        _cuda.add_launch_counts(g.delta)
        return _cuda.unflatten(g.tree, [o.clone() for o in g.outputs])

    def _capture(self, args):
        """The forward on static copies of `args` as one CUDA graph
        (:func:`ops.cuda.capture`), nested blocks running eagerly inside."""
        device = args[0].device
        inputs = [a.detach().clone() for a in args]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def forward():
            with torch.no_grad():
                return Block.__call__(self, *inputs)
        _CAPTURING.on = True
        try:
            graph, leaves, tree, delta = _cuda.capture(
                forward, device, self._pool, _random.generator(device),
                f"{type(self).__name__}: the captured forward")
        finally:
            _CAPTURING.on = False
        self.captures += 1
        return _Graph(graph, inputs, leaves, tree, delta, storage_epoch())

    def export(self, path, epoch=0):
        raise NotImplementedError(
            "HybridBlock.export (symbol JSON + params) is not ported yet "
            "(ROADMAP A.9); save_parameters writes the parameters")

    def freeze(self, input_shape, dtype="float32", **kwargs):
        """A :class:`serving.FrozenModel` of this block: `input_shape` is one
        sample's shape (no batch dim)."""
        from ..serving import FrozenModel
        return FrozenModel(self, input_shape, dtype=dtype, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """Not ported yet: a Symbol graph as a block (ROADMAP A.9)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SymbolBlock (a Symbol graph as a Gluon block) is not ported "
            "yet (ROADMAP A.9)")

    @staticmethod
    def imports(*args, **kwargs):
        raise NotImplementedError(
            "SymbolBlock.imports is not ported yet (ROADMAP A.9)")
