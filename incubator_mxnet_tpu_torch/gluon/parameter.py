"""Parameter and ParameterDict (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``; parity: python/mxnet/gluon/
parameter.py).

A :class:`Parameter` names a tensor of a :class:`~.block.Block` the MXNet
way: its full name (the block's prefix and its own, ``conv2d_0weight``),
``grad_req``, ``lr_mult``, ``wd_mult``, ``init`` and a shape that may hold
0s until the first forward completes it. The tensor itself is PyTorch's:

- a ``torch.nn.Parameter`` that the block registers under its attribute
  name, so ``state_dict``, ``.to()``, the optimizers and ``FusedTrainStep``
  see it as they see any module parameter; before its shape is known it is
  a ``torch.nn.UninitializedParameter`` (PyTorch's idiom for deferred
  shapes), which ``materialize`` turns into a Parameter in place;
- a module buffer for BatchNorm's moving statistics (``buffer=True``;
  ``grad_req="null"``, as on the JAX side, where they are parameters).

``lr_mult``, ``wd_mult`` and ``grad_req`` are also set on the tensor,
where the optimizers (``Optimizer._get_lr_wd``, ``FusedTrainStep``) and
:func:`autograd.backward` read them. A parameter with a known shape holds
its layer's starting value from construction (zeros, ones for ``init=
"ones"``, a constant for ``Constant``), so a network built with explicit
shapes runs before :meth:`initialize`.

The initializer precedence is the JAX package's: a parameter's own
``init`` wins over the one ``Block.initialize`` is given, which wins over
the default, ``Uniform(0.07)``. Draws come from
``random.generator(device)``.

Storage changes: every call that gives a parameter new storage (a move to
another device, ``cast``) bumps :func:`storage_epoch`, which a hybridized
block's CUDA graphs read (they read the parameters' storage in place).
``set_data``, ``initialize`` at the same device and ``load`` copy into the
storage a graph reads.

:meth:`Parameter.data` and :meth:`Parameter.grad` return NDArrays, as
the JAX package's do. The array of ``data()`` is the parameter's own
tensor: a write to it (``p.data()[:] = v``, ``+=``, ``copyto``) goes into
the parameter's storage in place, as ``set_data`` does, so a hybridized
block's CUDA graphs see it; ``p.data().torch()`` is the tensor.

``save``/``load`` keep the JAX package's file (``nd.save``: a pickle,
protocol 4, of ``("dict", {name: numpy array})``); a bf16 tensor is saved
as f32 (numpy has no bf16 without ml_dtypes) and read back in the
parameter's dtype.
"""
from __future__ import annotations

import pickle
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import initializer as _initializer
from ..context import as_context, ctx_from_device
from .. import ndarray as _nd
from ..ndarray import NDArray, _torch_dtype, _wrap

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "storage_epoch", "save_arrays", "load_arrays"]

_GRAD_REQS = ("write", "add", "null")
_EPOCH = [0]


class DeferredInitializationError(RuntimeError):
    pass


def storage_epoch() -> int:
    """A count that rises whenever a parameter's tensor gets new storage:
    a CUDA graph captured at an earlier count may read freed memory."""
    return _EPOCH[0]


def bump_storage_epoch():
    _EPOCH[0] += 1


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _start_value(init):
    """The value a parameter of known shape holds before ``initialize``:
    its own initializer where that draws nothing, else zero."""
    init = _initializer.create(init) if isinstance(init, str) else init
    if isinstance(init, _initializer.One):
        return 1.0
    if isinstance(init, _initializer.Constant):
        return float(init.value)
    return 0.0


def save_arrays(fname, arrays):
    """``nd.save(fname, {name: array})`` of the JAX package: tensors,
    NDArrays or numpy arrays by name (bf16 saved as f32)."""
    _nd.save(fname, dict(arrays))


def load_arrays(fname):
    """What ``nd.save`` wrote, as ``{name: numpy array}`` (a bf16 array of
    the JAX package, an ml_dtypes array, widened to f32)."""
    with open(fname, "rb") as f:
        kind, payload = pickle.load(f)
    if kind != "dict":
        raise ValueError(f"{fname} holds a {kind}, not a dict of arrays")
    out = {}
    for k, v in payload.items():
        a = np.asarray(v)
        out[k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


class Parameter:
    """A weight, bias or moving statistic of a Block.

    grad_req: "write" (each backward overwrites the gradient), "add" (each
    backward adds to it until ``zero_grad``) or "null" (no gradient).
    Shapes may hold 0 (unknown) for deferred initialization; the first
    forward completes them."""

    def __init__(self, name, shape=None, dtype="float32", init=None,
                 grad_req="write", lr_mult=1.0, wd_mult=1.0,
                 allow_deferred_init=True, differentiable=True,
                 buffer=False):
        self.name = name
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        self.dtype = _dtype_name(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._buffer = bool(buffer)
        self._owner = None            # weakref to the Block that registers it
        self._attr = None             # ... under this attribute name
        self._deferred = None         # (initializer, device) awaiting a shape
        self._initialized = False
        dt = _torch_dtype(dtype)
        if self.shape_is_known:
            t = torch.full(self._shape, _start_value(init), dtype=dt)
            if not self._buffer:
                t = torch.nn.Parameter(t)
        elif self._buffer:
            t = torch.nn.UninitializedBuffer(dtype=dt)
        else:
            t = torch.nn.UninitializedParameter(dtype=dt)
        self._tensor = t
        self._lr_mult, self._wd_mult = float(lr_mult), float(wd_mult)
        self.grad_req = grad_req if differentiable else "null"

    # -- the tensor -------------------------------------------------------
    def _bind(self, owner, attr):
        """Record the block that registers the tensor under `attr` (a
        buffer is looked up there: ``Module.to`` replaces buffers)."""
        if self._owner is None:
            self._owner, self._attr = weakref.ref(owner), attr

    @property
    def _var(self):
        if self._buffer and self._owner is not None:
            owner = self._owner()
            if owner is not None and self._attr in owner._buffers:
                # Module.to() replaced it: follow, and drop the old one
                self._tensor = owner._buffers[self._attr]
        return self._tensor

    # copies (copy.deepcopy, as FrozenModel makes one) and pickles take the
    # tensor the block holds and a weak reference to the copied block
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_tensor"] = self._var
        state["_owner"] = None if self._owner is None else self._owner()
        return state

    def __setstate__(self, state):
        owner = state.pop("_owner")
        self.__dict__.update(state)
        self._owner = None if owner is None else weakref.ref(owner)

    def _set_var(self, t):
        """Put `t` in the buffer's place (in the owner too)."""
        self._tensor = t
        if self._owner is not None:
            owner = self._owner()
            if owner is not None and self._attr in owner._buffers:
                owner._buffers[self._attr] = t

    @property
    def _lazy(self):
        return torch.nn.parameter.is_lazy(self._var)

    def _tag(self):
        """Put grad_req, lr_mult and wd_mult on the tensor, where autograd
        and the optimizers read them."""
        t = self._var
        t.grad_req = self._grad_req
        t.lr_mult = self._lr_mult
        t.wd_mult = self._wd_mult

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{req!r}")
        if self._buffer:
            req = "null"
        self._grad_req = req
        t = self._var
        if not self._buffer:
            t.requires_grad = req != "null"
            if req == "null" and not torch.nn.parameter.is_lazy(t):
                t.grad = None
        self._tag()

    @property
    def lr_mult(self):
        return self._lr_mult

    @lr_mult.setter
    def lr_mult(self, v):
        self._lr_mult = float(v)
        self._tag()

    @property
    def wd_mult(self):
        return self._wd_mult

    @wd_mult.setter
    def wd_mult(self, v):
        self._wd_mult = float(v)
        self._tag()

    # -- shape ------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new):
        if self._shape is not None:
            if len(self._shape) != len(new) or not all(
                    s in (0, n) for s, n in zip(self._shape, new)):
                raise ValueError(f"Inferred shape {tuple(new)} incompatible "
                                 f"with declared {self._shape} for parameter "
                                 f"{self.name}")
        self._shape = tuple(int(s) for s in new)

    @property
    def shape_is_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # -- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Draw the parameter on `ctx` (default ``gpu(0)``, which raises
        without a card) from `init`, else its own initializer, else
        `default_init` (what ``Block.initialize`` passes), else
        ``Uniform(0.07)``; a parameter of unknown shape waits for its first
        forward. An initialized parameter is left as it is unless
        `force_reinit`."""
        if self._initialized and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        device = as_context(ctx).device
        eff = (init or self.init or default_init
               or _initializer.create("uniform"))
        if isinstance(eff, str):
            eff = _initializer.create(eff)
        if isinstance(eff, _initializer.Mixed):
            eff = eff.init_for(self.name)
        if not self.shape_is_known:
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has unknown shape {self._shape}")
            self._deferred = (eff, device)
            return
        self._finish_init(eff, device)

    def _place(self, device=None):
        """Give the tensor its shape on `device` (materialize it; default
        the device and dtype the uninitialized tensor carries, which
        ``Module.to`` sets) or move it there; returns the tensor."""
        t = self._var
        if torch.nn.parameter.is_lazy(t):
            self.dtype = _dtype_name(t.dtype)
            t.materialize(self._shape, device=device or t.device,
                          dtype=t.dtype)
            self._tag()
            return t
        if device is None:
            return t
        if tuple(t.shape) != self._shape:
            raise ValueError(f"Parameter {self.name}: tensor of shape "
                             f"{tuple(t.shape)}, declared {self._shape}")
        if t.device != torch.device(device):
            with torch.no_grad():
                if self._buffer:
                    t = t.to(device)
                    self._set_var(t)
                else:
                    t.data = t.data.to(device)
            bump_storage_epoch()
            self._tag()
        return t

    def _finish_init(self, init, device):
        t = self._place(device)
        with torch.no_grad():
            t.copy_(init(self._shape, self.dtype, device=t.device))
        self._deferred = None
        self._initialized = True

    def finish_deferred_init(self):
        """Draw a deferred parameter now that its shape is known."""
        if self._deferred is None:
            if self._lazy:
                raise RuntimeError(
                    f"Parameter {self.name} is not initialized; call "
                    f".initialize() (or load its values) first")
            return
        if not self.shape_is_known:
            raise DeferredInitializationError(
                f"Parameter {self.name}: shape still unknown {self._shape}")
        self._finish_init(*self._deferred)

    # -- access -----------------------------------------------------------
    def data(self, ctx=None):
        """The parameter as an NDArray whose writes go into its storage
        (``.torch()`` is the tensor the block registers)."""
        return _wrap(self._tensor_checked(), inplace=True)

    def list_data(self):
        return [self.data()]

    def _tensor_checked(self):
        """The tensor, or an error if it is not initialized."""
        if self._lazy:
            if self._deferred is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred; call net once or set "
                    f"its shape")
            raise RuntimeError(f"Parameter {self.name} is not initialized; "
                               f"call .initialize()")
        return self._var

    def set_data(self, data):
        """Copy `data` (a tensor or array) into the parameter, in its dtype
        and on its device: into the storage it has, or, for a deferred
        parameter, into new storage of `data`'s shape (which completes the
        shape) on the device ``initialize`` named, else the device the
        module was moved to (the CPU if none)."""
        self._set_data(data)

    def _set_data(self, data, device=None):
        """:meth:`set_data`, the parameter moved to `device` first if
        given."""
        if isinstance(data, NDArray):
            data = data.torch()
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
            if data.dtype.name == "bfloat16":
                data = data.astype(np.float32)
            data = torch.from_numpy(np.ascontiguousarray(data))
        if self._lazy:
            self.shape = tuple(data.shape)
            if device is None and self._deferred is not None:
                device = self._deferred[1]
            t = self._place(device)
        else:
            t = self._place(device)
            if tuple(data.shape) != tuple(t.shape):
                raise ValueError(f"Parameter {self.name}: set_data of shape "
                                 f"{tuple(data.shape)}, expected "
                                 f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(data.to(device=t.device, dtype=t.dtype))
        self._deferred = None
        self._initialized = True

    def grad(self, ctx=None):
        """The gradient as an NDArray whose writes go into the gradient;
        before the first backward the gradient is made, as zeros."""
        if self._grad_req == "null":
            raise RuntimeError(f"Parameter {self.name} has no gradient "
                               f"(grad_req='null')")
        t = self._tensor_checked()
        if t.grad is None:
            t.grad = torch.zeros_like(t.detach())
        return _wrap(t.grad, inplace=True)

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient to zero in place (``grad_req="add"`` sums from
        there)."""
        t = self._var
        if not self._lazy and t.grad is not None:
            t.grad.zero_()

    def list_ctx(self):
        return [] if self._lazy else [ctx_from_device(self._var.device)]

    def reset_ctx(self, ctx):
        if not self._lazy:
            self._place(as_context(ctx).device)

    def cast(self, dtype):
        """Store the parameter in `dtype` (new storage; gradients
        dropped)."""
        self.dtype = _dtype_name(dtype)
        t = self._var
        dt = _torch_dtype(dtype)
        if self._lazy or t.dtype == dt:
            return
        with torch.no_grad():
            if self._buffer:
                self._set_var(t.to(dt))
            else:
                t.data = t.data.to(dt)
                t.grad = None
        bump_storage_epoch()
        self._tag()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter that holds `value` and takes no gradient (parity:
    gluon.Constant)."""

    def __init__(self, name, value):
        value = (value.detach().cpu() if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
        if value.dtype == torch.float64:
            value = value.float()
        super().__init__(name, shape=tuple(value.shape),
                         dtype=_dtype_name(value.dtype), init="zeros",
                         grad_req="null")
        self._value = value
        with torch.no_grad():
            self._var.copy_(value)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        t = self._place(as_context(ctx).device)
        with torch.no_grad():
            t.copy_(self._value.to(t.device))
        self._initialized = True


class ParameterDict:
    """Ordered name -> Parameter mapping (parity: gluon.ParameterDict)."""

    def __init__(self, prefix=""):
        self.prefix = prefix
        self._params = OrderedDict()

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, made with `kwargs` if new (a
        parameter shared through the block's ``params=`` is returned as
        it is)."""
        full = self.prefix + name
        if full in self._params:
            return self._params[full]
        p = Parameter(full, **kwargs)
        self._params[full] = p
        return p

    def get_constant(self, name, value=None):
        full = self.prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self._params[k] = v

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, k):
        return self._params[k]

    def __contains__(self, k):
        return k in self._params

    def __len__(self):
        return len(self._params)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, fname, strip_prefix=""):
        arrays = {}
        for name, p in self.items():
            if p._lazy:
                continue
            key = (name[len(strip_prefix):] if name.startswith(strip_prefix)
                   else name)
            arrays[key] = p._tensor_checked()
        save_arrays(fname, arrays)

    def load(self, fname, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        arrays = {restore_prefix + k: v
                  for k, v in load_arrays(fname).items()}
        for name, p in self.items():
            if name in arrays:
                p._set_data(arrays[name], None if ctx is None
                            else as_context(ctx).device)
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing from {fname}")
        if not ignore_extra:
            extra = set(arrays) - set(self._params)
            if extra:
                raise KeyError(f"File {fname} has extra parameters "
                               f"{sorted(extra)}")

    def __repr__(self):
        inner = "\n".join(f"  {p}" for p in self.values())
        return f"ParameterDict(\n{inner}\n)"
