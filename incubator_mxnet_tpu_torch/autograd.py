"""Recording scope and backward over PyTorch's autograd (counterpart of
``incubator_mxnet_tpu/autograd.py``).

PyTorch records every operation on a tensor that requires grad, so the port
keeps no tape of its own. What it keeps is MXNet's user flow::

    with autograd.record():
        loss = lm_loss(net(x), x)
    autograd.backward(loss)
    trainer.step(batch_size)

- :func:`record` enables grad and marks the thread as recording and, by
  default, training. Training mode is what dropout and the attention
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
  (they do not require grad).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "is_recording", "is_training", "backward"]

_STATE = threading.local()


def is_recording() -> bool:
    return getattr(_STATE, "recording", False)


def is_training() -> bool:
    return getattr(_STATE, "training", False)


class _Scope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._grad = torch.enable_grad()

    def __enter__(self):
        self._old = (is_recording(), is_training())
        _STATE.recording, _STATE.training = self._rec, self._train
        self._grad.__enter__()
        return self

    def __exit__(self, *exc):
        self._grad.__exit__(*exc)
        _STATE.recording, _STATE.training = self._old
        return False


def record(train_mode: bool = True) -> _Scope:
    """A scope in which operations are recorded for :func:`backward`
    (grad enabled) and, unless `train_mode` is False, run in training
    mode."""
    return _Scope(True, bool(train_mode))


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


def backward(heads, head_grads=None, retain_graph=False):
    """Backpropagate from `heads` (a tensor or a list of them) into the
    ``.grad`` of every leaf that requires grad, overwriting what a leaf
    the heads reach held before (``grad_req="write"``; a leaf tagged
    ``grad_req="add"`` adds to it). A head without a
    head gradient is seeded with ones: a vector head backpropagates its
    sum."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise ValueError(f"backward: {len(heads)} heads but "
                         f"{len(head_grads)} head gradients")
    seeds = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    for leaf in _reached_leaves(heads):
        if getattr(leaf, "grad_req", "write") != "add":
            leaf.grad = None
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
