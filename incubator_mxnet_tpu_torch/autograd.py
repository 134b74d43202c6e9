"""Recording scopes, backward, grad and custom Functions over PyTorch's
autograd (counterpart of ``incubator_mxnet_tpu/autograd.py``; parity:
python/mxnet/autograd.py).

PyTorch records every operation on a tensor that requires grad, so the port
keeps no tape of its own. What it keeps is MXNet's user flow::

    with autograd.record():
        loss = lm_loss(net(x), x)
    autograd.backward(loss)
    trainer.step(batch_size)

- :func:`record` enables grad and marks the thread as recording and, by
  default, training; :func:`pause` disables grad and recording (training
  off unless asked); :func:`train_mode` and :func:`predict_mode` change
  only the training flag. Training mode is what dropout and the attention
  kernel's selection rule read (:func:`is_training`), as in the JAX
  package; a module's ``train()``/``eval()`` flag is not consulted.
- :func:`backward` seeds a head without a gradient with ones, so a loss
  vector backpropagates its sum, as ``loss.backward()`` does in the JAX
  package (a bare ``torch.Tensor.backward()`` raises on a vector).
- :func:`backward` overwrites: MXNet's default ``grad_req="write"``. It
  sets ``.grad`` to None on every leaf the heads reach before it
  backpropagates, so two backwards without an update in between leave
  the second gradient, where PyTorch would add the two. A leaf the heads
  do not reach keeps its gradient, as in the JAX package. A leaf tagged
  ``grad_req="add"`` (a Gluon ``Parameter`` so set) keeps its gradient
  and the backward adds to it; ``"null"`` parameters take no gradient
  (they do not require grad). A leaf given a gradient buffer by
  :func:`mark_variables` keeps that buffer: the backward zeroes it
  (``"write"``) or adds to it (``"add"``) in place.
- :func:`grad` returns the gradients of chosen variables and writes no
  ``.grad``; with ``create_graph=True`` they are recorded, so a gradient
  of a gradient works through PyTorch's ops and through the kernels'
  Functions whose backward is closed-form PyTorch (layer norm,
  scale/shift/act, conv + BN + act). The flash-attention Function's
  backward runs kernels and is once differentiable: a second derivative
  through it raises on both devices, as ``jax.grad`` of ``jax.grad``
  through the Pallas kernels does.
- :class:`Function` is MXNet's custom op: ``forward`` and ``backward`` on
  tensors, joined to PyTorch's autograd by a ``torch.autograd.Function``.

Heads, head gradients, variables and gradient buffers may be NDArrays
(``nd``) or tensors; :func:`grad` answers in NDArrays when it is given
any.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "get_symbol"]

_STATE = threading.local()
_GRAD_REQS = ("write", "add", "null")


def is_recording() -> bool:
    return getattr(_STATE, "recording", False)


def is_training() -> bool:
    return getattr(_STATE, "training", False)


class _Scope:
    """Sets the recording and training flags inside (None leaves one as it
    is); recording on enables grad, recording off disables it."""

    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._grad = (None if recording is None else
                      torch.enable_grad() if recording else torch.no_grad())

    def __enter__(self):
        self._old = (is_recording(), is_training())
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        if self._grad is not None:
            self._grad.__enter__()
        return self

    def __exit__(self, *exc):
        if self._grad is not None:
            self._grad.__exit__(*exc)
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode: bool = True) -> _Scope:
    """A scope in which operations are recorded for :func:`backward`
    (grad enabled) and, unless `train_mode` is False, run in training
    mode."""
    return _Scope(True, bool(train_mode))


def pause(train_mode: bool = False) -> _Scope:
    """A scope in which nothing is recorded (grad disabled), in predict
    mode unless `train_mode` is True."""
    return _Scope(False, bool(train_mode))


def train_mode() -> _Scope:
    """A scope in training mode; recording stays as it is."""
    return _Scope(None, True)


def predict_mode() -> _Scope:
    """A scope in predict mode; recording stays as it is."""
    return _Scope(None, False)


def _tensor(v):
    """The tensor of a variable: a tensor, an NDArray's, or a Gluon
    ``Parameter``'s."""
    from .ndarray import _unwrap    # ndarray imports this module
    v = _unwrap(v)
    return v if isinstance(v, torch.Tensor) else v._tensor_checked()


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each of `variables` (leaf tensors or Gluon ``Parameter``s) a
    variable whose gradient :func:`backward` writes into the tensor of
    `gradients` at its place (the same object: zeroed and written for
    ``"write"``, added to for ``"add"``); ``"null"`` takes no gradient."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not len(variables) == len(gradients) == len(grad_reqs):
        raise ValueError(f"mark_variables: {len(variables)} variables, "
                         f"{len(gradients)} gradients and {len(grad_reqs)} "
                         f"grad_reqs")
    from .ndarray import NDArray    # ndarray imports this module
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{req!r}")
        t = _tensor(v)
        if t.grad_fn is not None:
            raise ValueError("mark_variables takes leaf tensors; pass "
                             "x.detach() for a computed one")
        if isinstance(v, (torch.Tensor, NDArray)):
            t.requires_grad_(req != "null")
            t.grad_req = req
        else:
            v.grad_req = req          # the Parameter tags its tensor
        t.grad_buffer = None if req == "null" else _tensor(g)
        t.grad = t.grad_buffer


# the type of the graph node that accumulates into a leaf's .grad
_ACCUMULATE_GRAD = type(
    torch.zeros(1, requires_grad=True).expand(1).grad_fn.next_functions[0][0])


def _reached_leaves(heads):
    """The leaves that require grad and that backpropagating from `heads`
    reaches: the ``variable`` of every ``AccumulateGrad`` node of the heads'
    graphs, and each head that is itself such a leaf."""
    leaves, stack, seen = [], [], set()
    for h in heads:
        if h.grad_fn is None:
            if h.requires_grad:
                leaves.append(h)
        elif h.grad_fn not in seen:
            seen.add(h.grad_fn)
            stack.append(h.grad_fn)
    while stack:
        node = stack.pop()
        if type(node) is _ACCUMULATE_GRAD:
            leaves.append(node.variable)
            continue
        for nxt, _ in node.next_functions:
            if nxt is not None and nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return leaves


def _heads_and_seeds(heads, head_grads):
    """`heads` as a list of tensors, and a seed for each: its head
    gradient, or ones where none is given."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    heads = [_tensor(h) for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    head_grads = [None if g is None else _tensor(g) for g in head_grads]
    if len(head_grads) != len(heads):
        raise ValueError(f"{len(heads)} heads but {len(head_grads)} head "
                         f"gradients")
    return heads, [torch.ones_like(h) if g is None else g
                   for h, g in zip(heads, head_grads)]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backpropagate from `heads` (a tensor or a list of them) into the
    ``.grad`` of every leaf that requires grad, overwriting what a leaf
    the heads reach held before (``grad_req="write"``; a leaf tagged
    ``grad_req="add"`` adds to it; a leaf given a buffer by
    :func:`mark_variables` keeps it). A head without a head gradient is
    seeded with ones: a vector head backpropagates its sum. `train_mode`
    is MXNet's and changes nothing here, as in the JAX package: the
    backward runs no forward again."""
    heads, seeds = _heads_and_seeds(heads, head_grads)
    for leaf in _reached_leaves(heads):
        req = getattr(leaf, "grad_req", "write")
        buf = getattr(leaf, "grad_buffer", None)
        if buf is not None:
            # the backward accumulates into a .grad in place
            if leaf.grad is not buf:
                leaf.grad = buf
            if req == "write":
                buf.zero_()
        elif req != "add":
            leaf.grad = None
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of `heads` with respect to `variables` (a tensor or
    ``Parameter``, or a list of them), returned in their order (a single
    tensor for a single variable) and written to no ``.grad``. A variable
    the heads do not reach gets zeros. With `create_graph` the gradients
    are recorded, so that a gradient of them can be taken (`retain_graph`
    follows `create_graph` unless given). `train_mode` changes nothing, as
    in :func:`backward`."""
    from .ndarray import _has_nd, _wrap_out    # ndarray imports this module
    single = not isinstance(variables, (list, tuple))
    given = [variables] if single else list(variables)
    as_nd = _has_nd(given) or _has_nd(
        heads if isinstance(heads, (list, tuple)) else [heads])
    varlist = [_tensor(v) for v in given]
    heads, seeds = _heads_and_seeds(heads, head_grads)
    live = [(h, s) for h, s in zip(heads, seeds) if h.requires_grad]
    wanted = [i for i, v in enumerate(varlist) if v.requires_grad]
    got = [None] * len(varlist)
    if live and wanted:
        found = torch.autograd.grad(
            [h for h, _ in live], [varlist[i] for i in wanted],
            [s for _, s in live], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(wanted, found):
            got[i] = g
    out = [torch.zeros_like(v) if g is None else g
           for v, g in zip(varlist, got)]
    if as_nd:
        out = _wrap_out(out)
    return out[0] if single else out


class _UserFunction(torch.autograd.Function):
    """Joins a :class:`Function` to PyTorch's autograd: the forward runs
    the user's ``forward`` under :func:`pause`, the backward hands the
    output gradients to the user's ``backward``."""

    @staticmethod
    def forward(ctx, func, *inputs):
        with pause():
            outputs = func.forward(*inputs)
        ctx.func = func
        ctx.single = not isinstance(outputs, (list, tuple))
        return outputs if ctx.single else tuple(outputs)

    @staticmethod
    def backward(ctx, *output_grads):
        grads = ctx.func.backward(*output_grads)
        if not isinstance(grads, (list, tuple)):
            grads = (grads,)
        return (None, *grads)


class Function:
    """A custom operation with its own gradient (MXNet's
    ``autograd.Function``). Subclass it, write ``forward(self, *inputs)``
    and ``backward(self, *output_grads)`` on tensors, keep what the
    backward needs with :meth:`save_for_backward` (read back as
    :attr:`saved_tensors`), and call an instance, one a call::

        class sigmoid(autograd.Function):
            def forward(self, x):
                y = 1 / (1 + torch.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    The forward runs under :func:`pause`. While recording, the outputs
    backpropagate through ``backward``, which returns one gradient an
    input. Called on NDArrays, it hands ``forward`` their tensors and
    returns NDArrays."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray import _has_nd, _wrap_out  # ndarray imports this module
        wrap = _has_nd(inputs)
        if wrap:
            inputs = [_tensor(x) for x in inputs]
        if is_recording():
            out = _UserFunction.apply(self, *inputs)
        else:
            with pause():
                out = self.forward(*inputs)
        return _wrap_out(out) if wrap else out

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError


def get_symbol(x):
    """MXNet lifts the recorded graph of `x` into a Symbol; the port has
    no ``symbol`` module yet (ROADMAP A.9), so this raises."""
    raise NotImplementedError(
        "autograd.get_symbol needs the symbol module, which the PyTorch "
        "port does not have yet (ROADMAP A.9)")
