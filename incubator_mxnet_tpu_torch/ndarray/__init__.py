"""NDArray: the imperative array type, backed by one ``torch.Tensor``
(counterpart of ``incubator_mxnet_tpu/ndarray/__init__.py``; parity:
python/mxnet/ndarray/ndarray.py).

An :class:`NDArray` wraps one tensor, ``_data``, as the JAX one wraps one
``jax.Array``. Every op is a PyTorch op, and every function of this module
funnels through :func:`_apply`, which unwraps its inputs, calls one torch
function and wraps the result: an NDArray in gives an NDArray out, and a
tensor in gives a tensor out, so a block's ``forward`` may call ``nd.*``
on the tensors the block passes it. Gradients are PyTorch's: inside
``autograd.record()`` an op on an NDArray is recorded by torch's autograd,
and outside it nothing is (the op runs under ``torch.no_grad``), as the
JAX package records only inside ``record()``. The port keeps no tape.

Mutation rebinds, as in the JAX package, whose arrays never alias:
``x[key] = v``, ``x += y``, ``copyto`` and ``out=`` give ``x`` a new
tensor (torch's slices, ``reshape`` and ``detach`` are views, so a write
in place would reach every array that shares the storage). An array
marked with :meth:`NDArray.attach_grad` stays a leaf that requires grad
across a write outside ``record()``, with its gradient and ``grad_req``.
The one exception is the array that ``gluon.Parameter.data()`` (or
``grad()``) returns: a write to it goes into the parameter's own storage,
in place, as ``set_data`` does, because a hybridized block's CUDA graphs
read that storage.

``dtype`` is a numpy dtype, except bf16, which numpy lacks without
``ml_dtypes``: there ``dtype`` is ``torch.bfloat16`` and :meth:`asnumpy`
returns float32. As in the JAX package (which runs with x64 off),
``array`` takes numpy's float64 to float32 and int64 to int32, integer
reductions keep int32, and ``argmax``, ``argsort`` and ``topk`` return
float32 indices by default; an explicit ``dtype="float64"`` is kept here
where the JAX package truncates it.

Not ported: ``Custom`` (``operator.CustomOp``, ROADMAP A.9), the sparse
storage types and ``embedding(sparse_grad=True)`` (``nd.sparse``, ROADMAP
A.5c), ``nd.contrib`` (the box, resize and control-flow ops, A.6), and
the JAX package's bulk, profiler, memory, flight and strict-sync hooks
(ROADMAP A.5d and A.11).
"""
from __future__ import annotations

import builtins
import math
import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd
from ..context import Context, as_context, ctx_from_device, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "concatenate", "stack", "split", "dot", "batch_dot",
           "save", "load", "waitall"]

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16, np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8, np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32, np.dtype("int64"): torch.int64,
    np.dtype("bool"): torch.bool, np.dtype("complex64"): torch.complex64,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}
# numpy literals without a dtype: float64 -> float32, int64 -> int32
_HOST_DEFAULTS = {np.dtype("float64"): np.dtype("float32"),
                  np.dtype("int64"): np.dtype("int32")}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a name, a numpy dtype, a Python type or a torch
    dtype ("bfloat16" names ``torch.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if str(dtype) == "bfloat16" or getattr(dtype, "__name__", "") == \
            "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def _np_dtype(tdtype):
    """The numpy dtype of a torch dtype (``torch.bfloat16`` stays)."""
    return tdtype if tdtype == torch.bfloat16 else _TORCH_TO_NP[tdtype]


def _is_int(t) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _host_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor of host data `x` (numpy array, list, scalar), with the JAX
    package's defaults where no `dtype` is given; a copy, never a view of
    the caller's array."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":                     # an ml_dtypes array
        a = a.astype(np.float32)
        dtype = torch.bfloat16 if dtype is None else dtype
    if dtype is None:
        a = a.astype(_HOST_DEFAULTS.get(a.dtype, a.dtype), copy=False)
        t = torch.from_numpy(np.array(a, copy=True))
    else:
        dt = _torch_dtype(dtype)
        if dt == torch.bfloat16:
            t = torch.from_numpy(np.array(a, np.float32)).to(dt)
        else:
            t = torch.from_numpy(np.array(a, _TORCH_TO_NP[dt]))
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# the funnel
# ---------------------------------------------------------------------------

def _apply(fn, inputs: Sequence, n_out: int = 1, name: Optional[str] = None):
    """Run one torch function `fn` on `inputs` (NDArrays or tensors) and
    return its `n_out` results: NDArrays if any input is an NDArray, else
    the tensors as they are. With NDArray inputs outside
    ``autograd.record()`` the call runs under ``torch.no_grad`` (nothing is
    recorded, as in the JAX package); inside it torch's autograd records
    it. An error raised by `fn` carries the note ``in nd.<name>``."""
    wrap = False
    raws = []
    for x in inputs:
        if isinstance(x, NDArray):
            wrap = True
            raws.append(x._data)
        else:
            raws.append(x)
    try:
        if not wrap:
            return fn(*raws)
        if torch.is_grad_enabled() and not autograd.is_recording() and \
                _needs_grad(raws):
            with torch.no_grad():
                outs = fn(*raws)
        else:
            outs = fn(*raws)
    except Exception as e:
        if name is not None:
            e.add_note(f"in nd.{name}")
        raise
    if n_out == 1:
        return _wrap(outs)
    return tuple(_wrap(o) for o in outs)


def _needs_grad(raws) -> bool:
    for r in raws:
        if isinstance(r, torch.Tensor) and r.requires_grad:
            return True
    return False


def _wrap(t: torch.Tensor, inplace: bool = False) -> "NDArray":
    """An NDArray around tensor `t`, as it is. With `inplace`, writes to
    the array go into `t`'s storage (a Parameter's data or gradient)."""
    out = NDArray.__new__(NDArray)
    out._data = t
    out._inplace = inplace
    return out


def _unwrap(x):
    """The tensor of an NDArray; anything else as it is."""
    return x._data if isinstance(x, NDArray) else x


# -- the boundary of the port's tensor-speaking modules (Gluon blocks,
# autograd, metrics, the fused step): NDArrays in, NDArrays out

def _has_nd(args, kwargs=None) -> bool:
    """Whether any of `args` or of `kwargs`' values is an NDArray (one
    ``isinstance`` test an argument: lists are not looked into, as
    :func:`_unwrap` does not unwrap them)."""
    for a in args:
        if isinstance(a, NDArray):
            return True
    return bool(kwargs) and _has_nd(tuple(kwargs.values()))


def _wrap_out(out):
    """Tensors (alone, or in a tuple or list) as NDArrays; anything else
    as it is."""
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o) for o in out)
    return out


def _is_sparse_operand(x):
    return hasattr(x, "stype") and not isinstance(x, NDArray)


def _refuse_sparse(*xs):
    for x in xs:
        if not isinstance(x, (NDArray, torch.Tensor, int, float)) and \
                _is_sparse_operand(x):
            raise NotImplementedError(
                "sparse operands (nd.sparse) are not ported yet (ROADMAP "
                "A.5c)")


def _lift(v, like: torch.Tensor):
    """A tensor for operand `v` beside tensor `like`: a Python scalar as a
    0-d tensor (int32 or float32, which loses to `like`'s dtype in type
    promotion as a JAX weak scalar does), host data through
    :func:`_host_tensor`, on `like`'s device."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, np.bool_)):
        return torch.full((), bool(v), dtype=torch.bool, device=like.device)
    if isinstance(v, (int, np.integer)):
        return torch.full((), int(v), dtype=torch.int32, device=like.device)
    if isinstance(v, (float, np.floating)):
        return torch.full((), float(v), dtype=torch.float32,
                          device=like.device)
    return _host_tensor(v, device=like.device)


def _binary(tfn, x, y, name=None):
    """`tfn` on two operands, one at least an NDArray or a tensor; the
    other may be a scalar or host data."""
    _refuse_sparse(x, y)
    xa, ya = isinstance(x, (NDArray, torch.Tensor)), isinstance(
        y, (NDArray, torch.Tensor))
    if xa and ya:
        return _apply(tfn, [x, y], name=name)
    if xa:
        return _apply(lambda a: tfn(a, _lift(y, a)), [x], name=name)
    return _apply(lambda b: tfn(_lift(x, b), b), [y], name=name)


def _unary(tfn, x, name=None, **kw):
    if kw:
        return _apply(lambda a: tfn(a, **kw), [x], name=name)
    return _apply(tfn, [x], name=name)


def _as_nd(x, like=None):
    """`x` as an NDArray or tensor (host data becomes an NDArray on the
    device of `like`, or the current context)."""
    if isinstance(x, (NDArray, torch.Tensor)):
        return x
    if like is not None:
        return _wrap(_lift(x, _unwrap(like)))
    return array(x)


def _releaf(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`new`, made the leaf that `old` was if `old` was marked by
    ``attach_grad`` (requires grad, no history): its gradient, grad_req
    and gradient buffer carried over."""
    if not (old.requires_grad and old.grad_fn is None):
        return new
    new = new.detach().requires_grad_(True)
    if old.grad is not None:
        new.grad = old.grad
    for attr in ("grad_req", "grad_buffer"):
        if hasattr(old, attr):
            setattr(new, attr, getattr(old, attr))
    return new


def _fix_index(key):
    """An index for torch: NDArrays unwrapped, host index arrays as
    tensors, integer index tensors as int64."""
    def one(k):
        k = _unwrap(k)
        if isinstance(k, (np.ndarray, list)) and not isinstance(k, bool):
            k = torch.from_numpy(np.asarray(k))
        if isinstance(k, torch.Tensor) and _is_int(k) and k.dtype not in (
                torch.bool, torch.int64):
            k = k.long()
        return k
    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


def _negative_steps(key):
    return builtins.any(isinstance(k, builtins.slice) and k.step is not None
                        and k.step < 0
                        for k in (key if isinstance(key, tuple) else (key,)))


def _index(a, key):
    """``a[key]`` with numpy's meaning, negative slice steps included
    (torch refuses them: a tuple of ints and slices is taken dim by
    dim)."""
    if not _negative_steps(key):
        return a[key]
    key = key if isinstance(key, tuple) else (key,)
    dim = 0
    for k in key:
        if isinstance(k, builtins.slice):
            idx = torch.arange(*k.indices(a.shape[dim]), device=a.device)
            a = a.index_select(dim, idx)
            dim += 1
        elif isinstance(k, (int, np.integer)):
            a = a.select(dim, int(k))
        else:
            raise IndexError(f"a negative slice step cannot be combined "
                             f"with index {k!r}")
    return a


class NDArray:
    """An n-dimensional array on a device: one ``torch.Tensor``."""

    __slots__ = ("_data", "_inplace", "__weakref__")

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            # host data lands on `ctx`, by default the current context
            data = _host_tensor(data, dtype, _device(ctx))
        else:
            if dtype is not None:
                data = data.to(_torch_dtype(dtype))
            if ctx is not None:
                data = data.to(_device(ctx))
        self._data = data
        self._inplace = False

    # -- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` for bf16)."""
        return _np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return ctx_from_device(self._data.device)

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        """The gradient (an NDArray that writes into it), or None."""
        t = self._data
        if not t.is_leaf or t.grad is None:
            return None
        return _wrap(t.grad, inplace=True)

    # -- materialization --------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A host copy (float32 for bf16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self._data.detach().reshape(()).item()

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def torch(self) -> torch.Tensor:
        """The backing tensor (escape hatch for interop, the counterpart
        of the JAX package's ``jax()``)."""
        return self._data

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write"):
        """Make this array a fresh leaf that requires grad, its gradient
        zeros, tagged with `grad_req` ("write", "add", or "null" for no
        gradient) as ``autograd.backward`` reads it."""
        if grad_req not in autograd._GRAD_REQS:
            raise ValueError(f"grad_req must be one of "
                             f"{autograd._GRAD_REQS}, got {grad_req!r}")
        t = self._data.detach()
        if grad_req != "null":
            t.requires_grad_(True)
            t.grad = torch.zeros_like(t)
            t.grad_req = grad_req
        self._data = t
        self._inplace = False
        return self

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph, train_mode)

    def detach(self) -> "NDArray":
        return _wrap(self._data.detach())

    # -- mutation ---------------------------------------------------------
    def _set(self, new: torch.Tensor):
        """Rebind to tensor `new` (see the module's note on mutation): into
        the storage for a Parameter's array, else a new tensor, a marked
        leaf kept a leaf outside ``record()``."""
        if self._inplace:
            with torch.no_grad():
                self._data.copy_(new)
            return self
        if not autograd.is_recording():
            new = _releaf(self._data, new)
        self._data = new
        return self

    # -- movement / casting ----------------------------------------------
    def astype(self, dtype, copy=True):
        dt = _torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _apply(lambda a: a.to(dt), [self], name="astype")

    def copy(self) -> "NDArray":
        return _apply(torch.clone, [self], name="copy")

    def copyto(self, other):
        """A copy on Context `other`, or this array's values written into
        NDArray `other` (in its dtype and on its device)."""
        if isinstance(other, Context):
            return _apply(lambda a: a.to(other.device, copy=True), [self],
                          name="copyto")
        other._set(_apply(lambda a: a.to(other._data.device,
                                         other._data.dtype, copy=True),
                          [self], name="copyto")._data)
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        dev = as_context(ctx).device
        if self._data.device == dev:
            return self
        return _apply(lambda a: a.to(dev), [self], name="as_in_context")

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        key = _fix_index(key)
        return _apply(lambda a: _index(a, key), [self], name="getitem")

    def __setitem__(self, key, value):
        key = _fix_index(key)
        if self._inplace:
            with torch.no_grad():
                self._data[key] = _lift(_unwrap(value), self._data).to(
                    self._data.dtype)
            return

        def f(a, v=value):
            out = a.clone()
            out[key] = _lift(v, a).to(a.dtype)
            return out
        if isinstance(value, (NDArray, torch.Tensor)):
            new = _apply(f, [self, value], name="setitem")
        else:
            new = _apply(f, [self], name="setitem")
        self._set(_unwrap(new))

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("truth value of multi-element NDArray is "
                             "ambiguous")
        return bool(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    __hash__ = object.__hash__  # identity hash; __eq__ below is elementwise

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o): return _binary(torch.add, self, o, "add")
    def __radd__(self, o): return _binary(torch.add, o, self, "add")
    def __sub__(self, o): return _binary(torch.sub, self, o, "sub")
    def __rsub__(self, o): return _binary(torch.sub, o, self, "sub")
    def __mul__(self, o): return _binary(torch.mul, self, o, "mul")
    def __rmul__(self, o): return _binary(torch.mul, o, self, "mul")
    def __truediv__(self, o): return _binary(torch.true_divide, self, o, "div")
    def __rtruediv__(self, o): return _binary(torch.true_divide, o, self, "div")
    def __floordiv__(self, o): return _binary(torch.floor_divide, self, o, "floordiv")
    def __rfloordiv__(self, o): return _binary(torch.floor_divide, o, self, "floordiv")
    def __mod__(self, o): return _binary(torch.remainder, self, o, "mod")
    def __rmod__(self, o): return _binary(torch.remainder, o, self, "mod")
    def __pow__(self, o): return _binary(torch.pow, self, o, "pow")
    def __rpow__(self, o): return _binary(torch.pow, o, self, "pow")
    def __matmul__(self, o): return _binary(torch.matmul, self, o, "matmul")
    def __neg__(self): return _unary(torch.neg, self, "neg")
    def __abs__(self): return _unary(torch.abs, self, "abs")

    def __iadd__(self, o):
        return self._set(self.__add__(o)._data)

    def __isub__(self, o):
        return self._set(self.__sub__(o)._data)

    def __imul__(self, o):
        return self._set(self.__mul__(o)._data)

    def __itruediv__(self, o):
        return self._set(self.__truediv__(o)._data)

    # -- comparisons (elementwise, parity with mx.nd) ---------------------
    def __eq__(self, o): return _binary(torch.eq, self, o, "eq")
    def __ne__(self, o): return _binary(torch.ne, self, o, "ne")
    def __lt__(self, o): return _binary(torch.lt, self, o, "lt")
    def __le__(self, o): return _binary(torch.le, self, o, "le")
    def __gt__(self, o): return _binary(torch.gt, self, o, "gt")
    def __ge__(self, o): return _binary(torch.ge, self, o, "ge")

    # -- shape manipulation ----------------------------------------------
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        return _apply(lambda a: a.reshape(shape), [self], name="reshape")

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, axes=None):
        return transpose(self, axes)

    def swapaxes(self, a1, a2):
        return swapaxes(self, a1, a2)

    def flatten(self):
        """MXNet semantics: collapse all but the first axis -> (N, -1)."""
        return flatten(self)

    def ravel(self):
        return _apply(lambda a: a.reshape(-1), [self], name="ravel")

    def expand_dims(self, axis):
        return expand_dims(self, axis)

    def squeeze(self, axis=None):
        return squeeze(self, axis)

    def broadcast_to(self, shape):
        return broadcast_to(self, shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return tile(self, reps)

    def repeat(self, repeats, axis=None):
        return repeat(self, repeats, axis)

    def flip(self, axis):
        return reverse(self, axis)

    def split(self, num_outputs, axis=0):
        return split(self, num_outputs, axis)

    def slice_axis(self, axis, begin, end):
        return slice_axis(self, axis, begin, end)

    # -- math methods (delegate to module fns) ----------------------------
    def sum(self, axis=None, keepdims=False): return sum(self, axis, keepdims)
    def mean(self, axis=None, keepdims=False): return mean(self, axis, keepdims)
    def max(self, axis=None, keepdims=False): return max(self, axis, keepdims)
    def min(self, axis=None, keepdims=False): return min(self, axis, keepdims)
    def prod(self, axis=None, keepdims=False): return prod(self, axis, keepdims)
    def argmax(self, axis=None, keepdims=False): return argmax(self, axis, keepdims)
    def argmin(self, axis=None, keepdims=False): return argmin(self, axis, keepdims)
    def norm(self, ord=2, axis=None, keepdims=False): return norm(self, ord, axis, keepdims)
    def var(self, axis=None, keepdims=False): return var(self, axis, keepdims)
    def std(self, axis=None, keepdims=False): return std(self, axis, keepdims)
    def abs(self): return abs(self)
    def exp(self): return exp(self)
    def log(self): return log(self)
    def sqrt(self): return sqrt(self)
    def square(self): return square(self)
    def sign(self): return sign(self)
    def round(self): return round(self)
    def floor(self): return floor(self)
    def ceil(self): return ceil(self)
    def clip(self, a_min=None, a_max=None): return clip(self, a_min, a_max)
    def relu(self): return relu(self)
    def sigmoid(self): return sigmoid(self)
    def tanh(self): return tanh(self)
    def softmax(self, axis=-1): return softmax(self, axis)
    def log_softmax(self, axis=-1): return log_softmax(self, axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return dot(self, other, transpose_a, transpose_b)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return one_hot(self, depth, on_value, off_value)

    def take(self, indices, axis=0):
        return take(self, indices, axis)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return topk(self, axis, k, ret_typ, is_ascend)

    def sort(self, axis=-1, is_ascend=True): return sort(self, axis, is_ascend)
    def argsort(self, axis=-1, is_ascend=True): return argsort(self, axis, is_ascend)
    def cumsum(self, axis=None): return cumsum(self, axis)

    # -- misc -------------------------------------------------------------
    def __repr__(self):
        vals = np.array2string(self.asnumpy(), precision=4,
                               suppress_small=True, threshold=20)
        dt = str(self._data.dtype).replace("torch.", "")
        return (f"{vals}\n<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context} {dt}>")

    def zeros_like(self): return zeros_like(self)
    def ones_like(self): return ones_like(self)


# ===========================================================================
# creation
# ===========================================================================

def _shape_of(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    return as_context(ctx).device


def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray of `source` (host data, a tensor or an NDArray) on `ctx`,
    by default the current context. Without `dtype`, numpy's float64
    becomes float32 and int64 int32 (the JAX package's defaults)."""
    device = _device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach().to(device=device, copy=True)
        if dtype is not None:
            t = t.to(_torch_dtype(dtype))
        return _wrap(t)
    return _wrap(_host_tensor(source, dtype, device))


def zeros(shape, ctx=None, dtype="float32") -> NDArray:
    return _wrap(torch.zeros(_shape_of(shape), dtype=_torch_dtype(dtype),
                             device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32") -> NDArray:
    return _wrap(torch.ones(_shape_of(shape), dtype=_torch_dtype(dtype),
                            device=_device(ctx)))


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return _wrap(torch.full(_shape_of(shape), val, dtype=_torch_dtype(dtype),
                            device=_device(ctx)))


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx, dtype)


def zeros_like(x) -> NDArray:
    return _apply(torch.zeros_like, [x], name="zeros_like")


def ones_like(x) -> NDArray:
    return _apply(torch.ones_like, [x], name="ones_like")


def full_like(x, val) -> NDArray:
    return _apply(lambda a: torch.full_like(a, val), [x], name="full_like")


def empty_like(x) -> NDArray:
    return zeros_like(x)


def mod(lhs, rhs) -> NDArray:
    return _binary(torch.remainder, lhs, rhs, "mod")


def astype(x, dtype, copy=True) -> NDArray:
    return x.astype(dtype, copy=copy)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step, dtype=_torch_dtype(dtype),
                     device=_device(ctx))
    if repeat != 1:
        a = torch.repeat_interleave(a, repeat)
    return _wrap(a)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype="float32") -> NDArray:
    dt = _torch_dtype(dtype)
    if endpoint:
        a = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        a = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]
    return _wrap(a.to(device=_device(ctx), dtype=dt))


def eye(N, M=None, k=0, ctx=None, dtype="float32") -> NDArray:
    M = N if M is None else M
    a = torch.ones(N, M, dtype=torch.bool).tril(k).triu(k)
    return _wrap(a.to(device=_device(ctx), dtype=_torch_dtype(dtype)))


identity = eye


# ===========================================================================
# elementwise / math
# ===========================================================================

def _make_unary(tfn, name):
    def f(x, out=None):
        r = _unary(tfn, _as_nd(x), name)
        if out is not None:
            return out._set(r._data)
        return r
    f.__name__ = name
    return f


def _cbrt(a):
    return torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)


def _float(a):
    """`a` in the floating dtype a JAX function of it returns."""
    return a if a.is_floating_point() else a.to(torch.float32)


exp = _make_unary(torch.exp, "exp")
expm1 = _make_unary(torch.expm1, "expm1")
log = _make_unary(torch.log, "log")
log2 = _make_unary(torch.log2, "log2")
log10 = _make_unary(torch.log10, "log10")
log1p = _make_unary(torch.log1p, "log1p")
sqrt = _make_unary(torch.sqrt, "sqrt")
rsqrt = _make_unary(lambda a: 1.0 / torch.sqrt(a), "rsqrt")
cbrt = _make_unary(lambda a: _cbrt(_float(a)), "cbrt")
rcbrt = _make_unary(lambda a: 1.0 / _cbrt(_float(a)), "rcbrt")
square = _make_unary(torch.square, "square")
abs = _make_unary(torch.abs, "abs")
sign = _make_unary(torch.sign, "sign")
floor = _make_unary(torch.floor, "floor")
ceil = _make_unary(torch.ceil, "ceil")
round = _make_unary(torch.round, "round")       # half to even, as jnp.round
rint = _make_unary(torch.round, "rint")
trunc = _make_unary(torch.trunc, "trunc")
fix = _make_unary(torch.trunc, "fix")
negative = _make_unary(torch.neg, "negative")
reciprocal = _make_unary(lambda a: 1.0 / a, "reciprocal")
sin = _make_unary(torch.sin, "sin")
cos = _make_unary(torch.cos, "cos")
tan = _make_unary(torch.tan, "tan")
arcsin = _make_unary(torch.arcsin, "arcsin")
arccos = _make_unary(torch.arccos, "arccos")
arctan = _make_unary(torch.arctan, "arctan")
sinh = _make_unary(torch.sinh, "sinh")
cosh = _make_unary(torch.cosh, "cosh")
tanh = _make_unary(torch.tanh, "tanh")
arcsinh = _make_unary(torch.arcsinh, "arcsinh")
arccosh = _make_unary(torch.arccosh, "arccosh")
arctanh = _make_unary(torch.arctanh, "arctanh")
erf = _make_unary(lambda a: torch.special.erf(_float(a)), "erf")
erfinv = _make_unary(lambda a: torch.special.erfinv(_float(a)), "erfinv")
gammaln = _make_unary(lambda a: torch.lgamma(_float(a)), "gammaln")
digamma = _make_unary(lambda a: torch.special.digamma(_float(a)), "digamma")
relu = _make_unary(torch.relu, "relu")
sigmoid = _make_unary(lambda a: torch.sigmoid(_float(a)), "sigmoid")
softsign = _make_unary(F.softsign, "softsign")
logical_not = _make_unary(torch.logical_not, "logical_not")
isnan = _make_unary(torch.isnan, "isnan")
isinf = _make_unary(torch.isinf, "isinf")
isfinite = _make_unary(torch.isfinite, "isfinite")


def softrelu(x):
    return _unary(F.softplus, _as_nd(x), "softrelu")


def gelu(x, approximate=True):
    return _unary(lambda a: F.gelu(a, approximate="tanh" if approximate
                                   else "none"), _as_nd(x), "gelu")


def leaky_relu(x, slope=0.25):
    return _unary(lambda a: F.leaky_relu(a, slope), _as_nd(x), "leaky_relu")


def elu(x, alpha=1.0):
    return _unary(lambda a: F.elu(a, alpha), _as_nd(x), "elu")


def selu(x):
    return _unary(F.selu, _as_nd(x), "selu")


def silu(x):
    return _unary(F.silu, _as_nd(x), "silu")


swish = silu


def softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        return _unary(lambda a: torch.softmax(a / temperature, axis), x,
                      "softmax")
    return _unary(lambda a: torch.softmax(a, axis), x, "softmax")


def log_softmax(x, axis=-1):
    return _unary(lambda a: torch.log_softmax(a, axis), x, "log_softmax")


def clip(x, a_min=None, a_max=None):
    return _unary(lambda a: torch.clamp(a, a_min, a_max), x, "clip")


def power(x, y): return _binary(torch.pow, x, y, "power")
def add(x, y): return _binary(torch.add, x, y, "add")
def subtract(x, y): return _binary(torch.sub, x, y, "subtract")
def multiply(x, y): return _binary(torch.mul, x, y, "multiply")
def divide(x, y): return _binary(torch.true_divide, x, y, "divide")
def modulo(x, y): return _binary(torch.remainder, x, y, "modulo")
def maximum(x, y): return _binary(torch.maximum, x, y, "maximum")
def minimum(x, y): return _binary(torch.minimum, x, y, "minimum")
def hypot(x, y): return _binary(lambda a, b: torch.hypot(_float(a), _float(b)), x, y, "hypot")
def arctan2(x, y): return _binary(lambda a, b: torch.arctan2(_float(a), _float(b)), x, y, "arctan2")
def equal(x, y): return _binary(torch.eq, x, y, "equal")
def not_equal(x, y): return _binary(torch.ne, x, y, "not_equal")
def greater(x, y): return _binary(torch.gt, x, y, "greater")
def greater_equal(x, y): return _binary(torch.ge, x, y, "greater_equal")
def lesser(x, y): return _binary(torch.lt, x, y, "lesser")
def less(x, y): return _binary(torch.lt, x, y, "less")
def lesser_equal(x, y): return _binary(torch.le, x, y, "lesser_equal")
def less_equal(x, y): return _binary(torch.le, x, y, "less_equal")
def logical_and(x, y): return _binary(torch.logical_and, x, y, "logical_and")
def logical_or(x, y): return _binary(torch.logical_or, x, y, "logical_or")
def logical_xor(x, y): return _binary(torch.logical_xor, x, y, "logical_xor")


# legacy explicit-broadcast aliases (the port broadcasts implicitly)
broadcast_add = add
broadcast_sub = subtract
broadcast_minus = subtract
broadcast_mul = multiply
broadcast_div = divide
broadcast_mod = modulo
broadcast_power = power
broadcast_maximum = maximum
broadcast_minimum = minimum
broadcast_equal = equal
broadcast_not_equal = not_equal
broadcast_greater = greater
broadcast_greater_equal = greater_equal
broadcast_lesser = lesser
broadcast_lesser_equal = lesser_equal
broadcast_logical_and = logical_and
broadcast_logical_or = logical_or
broadcast_logical_xor = logical_xor
elemwise_add = add
elemwise_sub = subtract
elemwise_mul = multiply
elemwise_div = divide


def where(cond, x, y):
    like = next((v for v in (cond, x, y)
                 if isinstance(v, (NDArray, torch.Tensor))), None)
    if like is None:
        cond = array(cond)
        like = cond
    cond, x, y = (_as_nd(v, like) for v in (cond, x, y))
    return _apply(lambda c, a, b: torch.where(c.bool(), a, b), [cond, x, y],
                  name="where")


# ===========================================================================
# reductions
# ===========================================================================

def _axes(axis, ndim):
    """`axis` (None, an int, a list or a tuple) as a tuple of dims."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % builtins.max(ndim, 1) for a in axis)
    return (int(axis) % builtins.max(ndim, 1),)


def _reduce(tfn, a, axis, keepdims, **kw):
    """`tfn(a, dim=d, keepdim=True)` over each dim of `axis` in turn (torch's
    reductions take one dim, or a tuple for some only), squeezed after
    unless `keepdims`."""
    if a.ndim == 0:
        return tfn(a.reshape(1), dim=0, keepdim=False, **kw)
    dims = _axes(axis, a.ndim)
    for d in dims:
        a = tfn(a, dim=d, keepdim=True, **kw)
    if not keepdims:
        a = a.reshape([n for i, n in enumerate(a.shape) if i not in dims])
    return a


def _acc_dtype(a):
    """JAX's accumulator for sums and products: the input's own dtype,
    int32 for bool (x64 off; torch would widen ints to int64)."""
    if a.dtype == torch.bool:
        return torch.int32
    return a.dtype


def sum(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.sum, a, axis, keepdims,
                                    dtype=_acc_dtype(a)), x, "sum")


def _nan_to(a, v):
    return torch.where(torch.isnan(a), torch.full_like(a, v), a) \
        if a.is_floating_point() else a


def nansum(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.sum, _nan_to(a, 0.0), axis,
                                    keepdims, dtype=_acc_dtype(a)),
                  x, "nansum")


def nanprod(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.prod, _nan_to(a, 1.0), axis,
                                    keepdims, dtype=_acc_dtype(a)),
                  x, "nanprod")


def degrees(x):
    return _unary(lambda a: torch.rad2deg(_float(a)), x, "degrees")


def radians(x):
    return _unary(lambda a: torch.deg2rad(_float(a)), x, "radians")


def argmax_channel(x):
    """Parity: mx.nd.argmax_channel - argmax over axis 1, float output."""
    return _unary(lambda a: torch.argmax(a, dim=1).to(torch.float32), x,
                  "argmax_channel")


def mean(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.mean, _float(a), axis, keepdims),
                  x, "mean")


def max(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.amax, a, axis, keepdims), x, "max")


def min(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.amin, a, axis, keepdims), x, "min")


def prod(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.prod, a, axis, keepdims,
                                    dtype=_acc_dtype(a)), x, "prod")


def _moment(a, axis, keepdims):
    """(mean kept, biased variance) of `a` over `axis`, jnp.var's ddof=0."""
    a = _float(a)
    m = _reduce(torch.mean, a, axis, True)
    return m, _reduce(torch.mean, (a - m) ** 2, axis, keepdims)


def var(x, axis=None, keepdims=False):
    return _unary(lambda a: _moment(a, axis, keepdims)[1], x, "var")


def std(x, axis=None, keepdims=False):
    return _unary(lambda a: torch.sqrt(_moment(a, axis, keepdims)[1]), x,
                  "std")


def _arg(tfn, a, axis, keepdims):
    if axis is None:
        r = tfn(a.reshape(-1))
        return r.reshape((1,) * a.ndim) if keepdims else r
    return tfn(a, dim=axis, keepdim=keepdims)


def argmax(x, axis=None, keepdims=False):
    return _unary(lambda a: _arg(torch.argmax, a, axis, keepdims).to(
        torch.float32), x, "argmax")


def argmin(x, axis=None, keepdims=False):
    return _unary(lambda a: _arg(torch.argmin, a, axis, keepdims).to(
        torch.float32), x, "argmin")


def norm(x, ord=2, axis=None, keepdims=False):
    def f(a):
        a = _float(a)
        if axis is None:
            # mx.nd.norm: entrywise norm over all elements (not spectral)
            r = torch.linalg.vector_norm(a.reshape(-1), ord)
            return r.reshape((1,) * a.ndim) if keepdims else r
        dims = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        return torch.linalg.norm(a, ord, dims, keepdims)
    return _unary(f, x, "norm")


def all(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.all, a.bool(), axis, keepdims), x,
                  "all")


def any(x, axis=None, keepdims=False):
    return _unary(lambda a: _reduce(torch.any, a.bool(), axis, keepdims), x,
                  "any")


def cumsum(x, axis=None, dtype=None):
    def f(a):
        dt = _acc_dtype(a) if dtype is None else _torch_dtype(dtype)
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=dt)
        return torch.cumsum(a, axis, dtype=dt)
    return _unary(f, x, "cumsum")


# ===========================================================================
# shape manipulation
# ===========================================================================

def reshape(x, shape):
    return _apply(lambda a: a.reshape(tuple(int(s) for s in shape)), [x],
                  name="reshape")


def transpose(x, axes=None):
    def f(a):
        return a.permute(tuple(reversed(range(a.ndim))) if axes is None
                         else tuple(axes))
    return _apply(f, [x], name="transpose")


def swapaxes(x, a1, a2):
    return _apply(lambda a: torch.swapaxes(a, a1, a2), [x], name="swapaxes")


def expand_dims(x, axis):
    return _apply(lambda a: torch.unsqueeze(a, axis), [x],
                  name="expand_dims")


def squeeze(x, axis=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        for d in sorted(_axes(axis, a.ndim), reverse=True):
            a = torch.squeeze(a, d)
        return a
    return _apply(f, [x], name="squeeze")


def flatten(x):
    return _apply(lambda a: a.reshape(a.shape[0], -1), [x], name="flatten")


def tile(x, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return _apply(lambda a: torch.tile(a, reps), [x], name="tile")


def repeat(x, repeats, axis=None):
    return _apply(lambda a: torch.repeat_interleave(a, repeats, axis), [x],
                  name="repeat")


def broadcast_to(x, shape):
    return _apply(lambda a: torch.broadcast_to(a, tuple(shape)), [x],
                  name="broadcast_to")


def broadcast_like(x, other):
    return broadcast_to(x, other.shape)


def broadcast_axis(x, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)

    def f(a):
        shape = list(a.shape)
        for ax, s in zip(axes, sizes):
            shape[ax] = s
        return torch.broadcast_to(a, shape)
    return _unary(f, x, "broadcast_axis")


def _arrays(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return list(args[0])
    return list(args)


def concat(*args, dim=1, axis=None):
    """MXNet's nd.concat: along `dim`, by default 1 (the channel axis)."""
    ax = axis if axis is not None else dim
    return _apply(lambda *xs: torch.cat(xs, ax), _arrays(args),
                  name="concat")


def concatenate(arrays, axis=0):
    return concat(*arrays, dim=axis)


def stack(*args, axis=0):
    return _apply(lambda *xs: torch.stack(xs, axis), _arrays(args),
                  name="stack")


def add_n(*args):
    """Sum of N arrays (parity: mx.nd.add_n / ElementWiseSum)."""
    def f(*xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total
    return _apply(f, _arrays(args), name="add_n")


ElementWiseSum = add_n


def reshape_like(lhs, rhs):
    """Reshape lhs to rhs's shape (parity: mx.nd.reshape_like)."""
    return _apply(lambda a, b: a.reshape(b.shape), [_as_nd(lhs),
                                                    _as_nd(rhs)],
                  name="reshape_like")


def multi_sum_sq(*arrays, num_arrays=None):
    """Per-array sum of squares (parity: mx.nd.multi_sum_sq): one 1-D
    array of shape (num_arrays,)."""
    arrays = _arrays(arrays)
    if num_arrays is not None and num_arrays != len(arrays):
        raise ValueError(f"num_arrays={num_arrays} but got "
                         f"{len(arrays)} arrays")
    return _apply(lambda *xs: torch.stack([torch.square(x).float().sum()
                                           for x in xs]),
                  arrays, name="multi_sum_sq")


def khatri_rao(*args):
    """Column-wise Kronecker product (parity: mx.nd.khatri_rao): inputs
    (r_i, k) -> (prod r_i, k)."""
    def f(*xs):
        out = xs[0]
        for b in xs[1:]:
            out = (out[:, None, :] * b[None, :, :]).reshape(-1, b.shape[1])
        return out
    return _apply(f, _arrays(args), name="khatri_rao")


def split(x, num_outputs, axis=0, squeeze_axis=False):
    if num_outputs == 1:
        # parity: mx.nd.split with one output returns the array itself
        return _apply(lambda a: torch.squeeze(a, axis) if squeeze_axis
                      else a, [x], name="split")

    def f(a):
        n = a.shape[axis]
        if n % num_outputs:
            raise ValueError(f"split: axis {axis} of size {n} does not "
                             f"divide into {num_outputs} equal parts")
        parts = torch.split(a, n // num_outputs, axis)
        if squeeze_axis:
            parts = [torch.squeeze(p, axis) for p in parts]
        return tuple(parts)
    return _apply(f, [x], n_out=num_outputs, name="split")


SliceChannel = split


def slice_axis(x, axis, begin, end):
    def f(a):
        n = a.shape[axis]
        b = begin if begin >= 0 else n + begin
        e = n if end is None else (end if end >= 0 else n + end)
        return a.narrow(axis, b, e - b)
    return _unary(f, x, "slice_axis")


def slice(x, begin, end, step=None):
    def f(a):
        idx = tuple(builtins.slice(b, e, s) for b, e, s in
                    zip(begin, end, step or [None] * len(begin)))
        return _index(a, idx)
    return _unary(f, x, "slice")


def crop(x, begin=None, end=None, step=None, **kwargs):
    """Legacy alias of nd.slice (parity: mx.nd.crop)."""
    if kwargs:
        raise TypeError("crop: unsupported kwargs %s (the center_crop/"
                        "offset form is not implemented; use nd.slice)"
                        % sorted(kwargs))
    return slice(x, begin, end, step)


def moments(x, axes=None, keepdims=False):
    """Mean and variance in one pass (parity: mx.nd.moments). Returns
    (mean, var)."""
    def f(a):
        m, v = _moment(a, axes, keepdims)
        if not keepdims:
            m = m.reshape(v.shape)
        return m, v
    return _apply(f, [x], n_out=2, name="moments")


def softmin(x, axis=-1):
    """Parity: mx.nd.softmin - softmax of the negated input."""
    return _unary(lambda a: torch.softmax(-a, axis), x, "softmin")


def slice_like(x, shape_like, axes=None):
    def f(a, b):
        idx = []
        for ax in range(a.ndim):
            if axes is None or ax in axes:
                idx.append(builtins.slice(0, b.shape[ax]))
            else:
                idx.append(builtins.slice(None))
        return a[tuple(idx)]
    return _apply(f, [x, shape_like], name="slice_like")


def _pad_index(n, before, after, mode, device):
    """Source positions of a padded axis of length `n` (numpy's "edge" and
    "reflect")."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, builtins.max(period, 1))
    return torch.where(i >= n, period - i, i)


def pad(x, mode="constant", pad_width=None, constant_value=0):
    """MXNet pad: pad_width is a flat tuple (before0, after0, before1,
    ...); mode "constant", "edge" or "reflect"."""
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)

    def f(a):
        pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
              for i in range(a.ndim)]
        if mode == "constant":
            flat = [p for b, e in reversed(pw) for p in (b, e)]
            return F.pad(a, flat, value=constant_value)
        for d, (b, e) in enumerate(pw):
            if b or e:
                a = a.index_select(d, _pad_index(a.shape[d], b, e, mode,
                                                 a.device))
        return a
    return _unary(f, x, "pad")


def diag(x, k=0):
    return _unary(lambda a: torch.diag(a, k) if a.ndim <= 2
                  else torch.diagonal(a, k, -2, -1), x, "diag")


def tril(x, k=0):
    return _unary(lambda a: torch.tril(a, k), x, "tril")


def triu(x, k=0):
    return _unary(lambda a: torch.triu(a, k), x, "triu")


def roll(x, shift, axis=None):
    def f(a):
        if axis is None:
            return torch.roll(a.reshape(-1), shift).reshape(a.shape)
        return torch.roll(a, shift, axis)
    return _unary(f, x, "roll")


# ===========================================================================
# indexing-ish ops
# ===========================================================================

def _long(i):
    """Integer indices as int64 (a float index truncates, as astype
    int32 does in the JAX package)."""
    return i.long() if i.dtype != torch.int64 else i


def take(x, indices, axis=0, mode="clip"):
    """Rows of `x` along `axis` at `indices`; out-of-range indices are
    clipped (``mode="clip"``, the default) or wrapped (``"wrap"``)."""
    indices = _as_nd(indices, x)

    def f(a, i):
        n = a.shape[axis]
        i = _long(i)
        i = i.clamp(0, n - 1) if mode == "clip" else torch.remainder(i, n)
        ax = axis % a.ndim
        out = a.index_select(ax, i.reshape(-1))
        return out.reshape(a.shape[:ax] + i.shape + a.shape[ax + 1:])
    if mode not in ("clip", "wrap"):
        raise ValueError(f"take mode must be 'clip' or 'wrap', got {mode!r}")
    return _apply(f, [x, indices], name="take")


def pick(x, index, axis=-1, keepdims=False):
    index = _as_nd(index, x)

    def f(a, i):
        r = torch.gather(a, axis, _long(i).unsqueeze(axis))
        return r if keepdims else torch.squeeze(r, axis)
    return _apply(f, [x, index], name="pick")


def gather_nd(x, indices):
    indices = _as_nd(indices, x)

    def f(a, idx):
        idx = _long(idx)
        return a[tuple(idx[i] for i in range(idx.shape[0]))]
    return _apply(f, [x, indices], name="gather_nd")


def scatter_nd(data, indices, shape):
    """Parity: mx.nd.scatter_nd - inverse of gather_nd; duplicate indices
    take the last write (the reference leaves duplicates undefined)."""
    data = _as_nd(data)
    indices = _as_nd(indices, data)

    def f(vals, idx):
        idx = _long(idx)
        out = torch.zeros(tuple(shape), dtype=vals.dtype, device=vals.device)
        return out.index_put(tuple(idx[i] for i in range(idx.shape[0])),
                             vals)
    return _apply(f, [data, indices], name="scatter_nd")


def batch_take(a, indices):
    """Parity: mx.nd.batch_take - out[i] = a[i, indices[i]]."""
    indices = _as_nd(indices, a)

    def f(x, i):
        return torch.gather(x, 1, _long(i)[:, None])[:, 0]
    return _apply(f, [a, indices], name="batch_take")


def reverse(data, axis=0):
    """Parity: mx.nd.reverse - flip along the given axis/axes."""
    axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return _apply(lambda x: torch.flip(x, axes), [data], name="reverse")


flip = reverse


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of `depth` with `on_value` at each index (an index outside
    ``[0, depth)`` gives a row of `off_value`)."""
    indices = _as_nd(indices)
    dt = _torch_dtype(dtype)

    def f(i):
        hot = _long(i).unsqueeze(-1) == torch.arange(depth, device=i.device)
        oh = hot.to(dt)
        if on_value != 1.0 or off_value != 0.0:
            oh = oh * (on_value - off_value) + off_value
        return oh
    return _unary(f, indices, "one_hot")


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, oor_policy="clip"):
    """Parity: nd.Embedding - rows of `weight` by the ids `data`, which
    follow ``ops.normalize_ids``: rounded to int32, out-of-range ids
    clipped (``oor_policy="clip"``) or refused (``"error"``).
    ``sparse_grad=True`` raises: its row-sparse gradient needs
    ``nd.sparse`` (ROADMAP A.5c)."""
    if sparse_grad:
        raise NotImplementedError(
            "embedding(sparse_grad=True) makes a row-sparse gradient; "
            "nd.sparse is not ported yet (ROADMAP A.5c)")
    from ..ops import _raw
    data = _as_nd(data, weight)
    vocab = int(input_dim if input_dim is not None else weight.shape[0])
    return _apply(lambda i, w: _raw._Embedding.apply(
        _raw.normalize_ids(i, vocab, oor_policy), w), [data, weight],
        name="embedding")


Embedding = embedding


def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with `is_ascend`) along `axis`: their
    indices in `dtype` (float32 by default, as in the JAX package), their
    values, both, or a mask."""
    if ret_typ not in ("indices", "value", "both", "mask"):
        raise ValueError(f"topk ret_typ must be indices|value|both|mask, "
                         f"got {ret_typ!r}")
    dt = _torch_dtype(dtype)

    def f(a):
        vals, idx = torch.topk(a, k, dim=axis, largest=not is_ascend,
                               sorted=True)
        if ret_typ == "mask":
            return torch.zeros(a.shape, dtype=dt, device=a.device).scatter(
                axis, idx, 1)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return vals, idx.to(dt)
        return idx.to(dt)
    return _apply(f, [x], n_out=2 if ret_typ == "both" else 1, name="topk")


def sort(x, axis=-1, is_ascend=True):
    return _unary(lambda a: torch.sort(a, dim=axis,
                                       descending=not is_ascend)[0],
                  x, "sort")


def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """Indices that sort `x` along `axis` (stable ascending, reversed for
    descending as the JAX package reverses), in `dtype`."""
    dt = _torch_dtype(dtype)

    def f(a):
        s = torch.argsort(a, dim=axis, stable=True)
        if not is_ascend:
            s = torch.flip(s, (axis,))
        return s.to(dt)
    return _unary(f, x, "argsort")


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Parity: nd.SequenceMask - mask positions beyond each sequence
    length. `data` layout: (seq, batch, ...) for axis=0, (batch, seq, ...)
    for axis=1."""
    if not use_sequence_length or sequence_length is None:
        return data
    sequence_length = _as_nd(sequence_length, data)

    def f(a, sl):
        pos = torch.arange(a.shape[axis], device=a.device)
        mask = pos[None, :] < _long(sl)[:, None]          # (batch, seq)
        if axis == 0:
            mask = mask.T                                 # (seq, batch)
        mask = mask.reshape(mask.shape + (1,) * (a.ndim - 2))
        return torch.where(mask, a, torch.full((), value, dtype=a.dtype,
                                               device=a.device))
    return _apply(f, [data, sequence_length], name="sequence_mask")


SequenceMask = sequence_mask


# ===========================================================================
# linear algebra
# ===========================================================================

def _dot(x, y, transpose_a=False, transpose_b=False):
    """MXNet dot on tensors: the last axis of x against the first of y;
    transpose_a swaps x's last two axes, transpose_b y's first two."""
    if transpose_a and x.ndim > 1:
        x = torch.swapaxes(x, -1, -2)
    if transpose_b and y.ndim > 1:
        y = torch.swapaxes(y, 0, 1)
    if x.ndim == 1 and y.ndim == 1:
        return torch.dot(x, y)
    return torch.tensordot(x, y, dims=1)


def dot(a, b, transpose_a=False, transpose_b=False):
    """MXNet dot: contract the last axis of a with the first axis of b."""
    _refuse_sparse(a, b)
    return _apply(lambda x, y: _dot(x, y, transpose_a, transpose_b), [a, b],
                  name="dot")


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    def f(x, y):
        if transpose_a:
            x = torch.swapaxes(x, -1, -2)
        if transpose_b:
            y = torch.swapaxes(y, -1, -2)
        return torch.matmul(x, y)
    return _apply(f, [a, b], name="batch_dot")


def matmul(a, b):
    return _binary(torch.matmul, a, b, "matmul")


def einsum(subscripts, *operands):
    return _apply(lambda *xs: torch.einsum(subscripts, *xs), list(operands),
                  name="einsum")


def outer(a, b):
    return _apply(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)),
                  [a, b], name="outer")


# ===========================================================================
# persistence (parity: mx.nd.save / mx.nd.load)
# ===========================================================================

def _host(x):
    """A numpy copy of an NDArray, a tensor (f32 for bf16) or host data."""
    if isinstance(x, torch.Tensor):
        x = _wrap(x)
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def save(fname, data):
    """Save an NDArray, a list of them or a dict of them by name, in the
    JAX package's file: a pickle, protocol 4, of ``("single"|"list"|
    "dict", numpy)`` (bf16 saved as float32)."""
    if isinstance(data, (NDArray, torch.Tensor)):
        payload = ("single", _host(data))
    elif isinstance(data, (list, tuple)):
        payload = ("list", [_host(x) for x in data])
    elif isinstance(data, dict):
        payload = ("dict", {k: _host(v) for k, v in data.items()})
    else:
        raise TypeError(f"cannot save {type(data)}")
    with open(fname, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def load(fname, ctx=None):
    """What :func:`save` (of either package) wrote, as NDArrays on `ctx`,
    by default the current context."""
    with open(fname, "rb") as f:
        kind, payload = pickle.load(f)
    if kind == "single":
        return array(payload, ctx)
    if kind == "list":
        return [array(x, ctx) for x in payload]
    return {k: array(v, ctx) for k, v in payload.items()}


def waitall():
    """Parity: mx.nd.waitall - wait for the work queued on the current CUDA
    device and on every other one that holds memory of this process. A
    card the process never used is left alone: synchronizing it would make
    a CUDA context there."""
    if torch.cuda.is_initialized():
        current = torch.cuda.current_device()
        for i in range(torch.cuda.device_count()):
            if i == current or torch.cuda.memory_reserved(i) > 0:
                torch.cuda.synchronize(i)


def moveaxis(x, source, destination):
    return _unary(lambda a: torch.movedim(a, source, destination), x,
                  "moveaxis")


def cast(x, dtype):
    return x.astype(dtype)


Cast = cast


def stop_gradient(x):
    return _unary(torch.Tensor.detach, x, "stop_gradient")


BlockGrad = stop_gradient
block_grad = stop_gradient


def Custom(*args, op_type=None, **kwargs):
    """mx.nd.Custom runs a registered ``operator.CustomOp``; the port has
    no ``operator`` module yet (ROADMAP A.9), so this raises."""
    raise NotImplementedError(
        "nd.Custom needs operator.CustomOp, which the PyTorch port does not "
        "have yet (ROADMAP A.9)")


def meshgrid(*arrays, indexing="xy"):
    """Parity: np.meshgrid surface used by reference scripts."""
    arrs = [_as_nd(a) for a in arrays]
    if len(arrs) == 1:
        return [_apply(lambda r: torch.meshgrid(r, indexing=indexing)[0],
                       arrs, name="meshgrid")]
    return list(_apply(lambda *raws: tuple(torch.meshgrid(
        *raws, indexing=indexing)), arrs, n_out=len(arrs), name="meshgrid"))


def shape_array(x):
    """Parity: mx.nd.shape_array - the shape as a 1-D int32 array (the
    reference uses int64; the JAX package int32), on `x`'s device."""
    return _apply(lambda a: torch.tensor(a.shape, dtype=torch.int32,
                                         device=a.device), [x],
                  name="shape_array")


def size_array(x):
    """Parity: mx.nd.size_array (int32, see shape_array)."""
    return _apply(lambda a: torch.tensor([a.numel()], dtype=torch.int32,
                                         device=a.device), [x],
                  name="size_array")


def gamma(x):
    """Parity: mx.nd.gamma - the gamma function, including the alternating
    sign on the negative non-integer axis (exp(gammaln) alone is |gamma|)."""
    def f(a):
        a = _float(a)
        mag = torch.exp(torch.lgamma(a))
        neg_sign = torch.where(torch.remainder(torch.floor(a), 2) == 0,
                               1.0, -1.0).to(a.dtype)
        return torch.where(a > 0, mag, neg_sign * mag)
    return _unary(f, x, name="gamma")


def hard_sigmoid(x, alpha=0.2, beta=0.5):
    """Parity: mx.nd.hard_sigmoid."""
    return _unary(lambda a: torch.clamp(alpha * a + beta, 0.0, 1.0), x,
                  name="hard_sigmoid")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return _unary(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                  name="nan_to_num")


def depth_to_space(x, block_size):
    """Parity: mx.nd.depth_to_space (NCHW, DCR order like the reference)."""
    b = int(block_size)

    def f(a):
        n, c, h, w = a.shape
        a = a.reshape(n, b, b, c // (b * b), h, w)
        a = a.permute(0, 3, 4, 1, 5, 2)
        return a.reshape(n, c // (b * b), h * b, w * b)
    return _unary(f, x, name="depth_to_space")


def space_to_depth(x, block_size):
    """Parity: mx.nd.space_to_depth (inverse of depth_to_space)."""
    b = int(block_size)

    def f(a):
        n, c, h, w = a.shape
        a = a.reshape(n, c, h // b, b, w // b, b)
        a = a.permute(0, 3, 5, 1, 2, 4)
        return a.reshape(n, c * b * b, h // b, w // b)
    return _unary(f, x, name="space_to_depth")


def ravel_multi_index(data, shape):
    """Parity: mx.nd.ravel_multi_index - data (M, N) column-per-point."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]

    def f(a):
        st = torch.tensor(strides, dtype=torch.int32, device=a.device)
        return (a.to(torch.int32) * st[:, None]).sum(0, dtype=torch.int32)
    return _unary(f, _as_nd(data), name="ravel_multi_index")


def unravel_index(data, shape):
    """Parity: mx.nd.unravel_index - returns (M, N) column-per-point."""
    def f(a):
        return torch.stack(torch.unravel_index(a.to(torch.int64),
                                               tuple(shape))).to(torch.int32)
    return _unary(f, _as_nd(data), name="unravel_index")


def hsplit(x, num_outputs):
    return split(x, num_outputs, axis=1)


def vsplit(x, num_outputs):
    return split(x, num_outputs, axis=0)


Pad = pad

from . import random  # noqa: E402  (registers the nd.random namespace)
# the sample_* family is nd's as well as nd.random's, as in the reference
from .random import (sample_exponential, sample_gamma,  # noqa: E402
                     sample_normal, sample_poisson, sample_uniform, shuffle)
from . import linalg  # noqa: E402  (registers the nd.linalg namespace)


class _Unported:
    """A namespace of ``nd`` that is not ported yet: every attribute
    raises ``NotImplementedError`` naming its ROADMAP item."""

    def __init__(self, name, what, item):
        self._name, self._what, self._item = name, what, item

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(
            f"nd.{self._name}.{attr}: {self._what} are not ported yet "
            f"(ROADMAP {self._item})")


sparse = _Unported("sparse", "the sparse storage types", "A.5c")
# the JAX package's ops package makes nd.contrib (box, resize and
# control-flow ops), which come with ops/box.py
contrib = _Unported("contrib", "the contrib operators", "A.6")
