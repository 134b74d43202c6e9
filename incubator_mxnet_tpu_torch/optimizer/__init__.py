"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer/__init__.py``):
``Optimizer``, ``create`` and the rules ``sgd``, ``adam`` and ``adamw``.

The arithmetic is the JAX package's, step for step: the gradient is cast
to f32, multiplied by ``rescale_grad`` and clipped to ``clip_gradient``;
the rule then runs in f32 on an f32 view of the weight, and the result is
cast back to the weight's dtype. Each index keeps its own update count
``t`` (bias correction uses it) and the optimizer the largest of them,
``num_update``. A parameter's ``lr_mult``/``wd_mult`` attributes, where
set, scale its learning rate and weight decay.

Multi-precision: with ``multi_precision=True`` a bf16 or f16 weight keeps
an f32 master copy as the first entry of its state
(:meth:`Optimizer.create_state_multi_precision`); the rule runs on the
master and the weight becomes the master cast to its dtype, so updates
smaller than half a bf16 step accumulate instead of being lost.

Each rule is written once, over lists of tensors with ``torch._foreach_*``
ops: ``update_multi`` applies it to every parameter that shares a learning
rate, weight decay and count in one multi-tensor launch per op (the JAX
package's ``fused_update`` fuses its jitted rule the same way), masters
with the f32 weights, and ``update`` is a list of one. Where the JAX
package returns new arrays, the port updates the weight and the state in
place (``torch.no_grad``). The state is f32 on the parameter's device.
``rescale_grad`` may be a 0-d tensor on that device, and ``skip`` (the
AMP overflow flag) a 0-d bool there: a skipped update leaves weights,
masters and states bit-unchanged, with nothing read back to the host. The
Trainer packs every state into one buffer (:func:`pack_states`), so the
snapshot and the select of a skip are one launch each for all of them. The
learning-rate schedulers and the other rules of the JAX package are not
ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register",
           "pack_states"]

_REGISTRY: dict = {}
# the weight dtypes that keep an f32 master under multi_precision
_LOW = (torch.float16, torch.bfloat16)


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def create(name, **kwargs):
    """The optimizer registered as `name` (case-insensitive)."""
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REGISTRY)}") from None
    return cls(**kwargs)


class Optimizer:
    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, multi_precision=False, param_dict=None,
                 begin_num_update=0):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.param_dict = param_dict or {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _get_lr_wd(self, index):
        lr, wd = self.learning_rate, self.wd
        p = self.param_dict.get(index)
        if p is not None:
            lr *= getattr(p, "lr_mult", 1.0)
            wd *= getattr(p, "wd_mult", 1.0)
        return lr, wd

    def _update_count(self, index):
        n = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = n
        self.num_update = max(self.num_update, n)

    def create_state(self, index, weight):
        return ()

    def _has_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW

    def create_state_multi_precision(self, index, weight):
        """``(f32 master,) + rule state`` for a bf16 or f16 weight under
        ``multi_precision``; otherwise the rule's state."""
        if self._has_master(weight):
            master = weight.detach().to(torch.float32)
            return (master,) + tuple(self.create_state(index, master))
        return self.create_state(index, weight)

    def _zeros(self, weight):
        return torch.zeros(weight.shape, dtype=torch.float32,
                           device=weight.device)

    def _update(self, ws, gs, states, lr, wd, t):
        """The rule, in place on the f32 weights `ws` and the states; `gs`
        are the rescaled, clipped f32 gradients and may be overwritten."""
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        """One update of `weight` (in place) from `grad`; returns the
        state."""
        return self.update_multi([index], [weight], [grad], [state])[0]

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states, skip=None):
        """Update every weight (in place) from its gradient; returns the
        states. Parameters that share a learning rate, weight decay and
        update count go through the rule together: a weight with a master
        copy (see :meth:`create_state_multi_precision`) through its master,
        any other through an f32 view. Where `skip` (a 0-d bool tensor) is
        true, every weight, master and state is selected back to its value
        before the call: states that are views of one buffer (see
        :func:`pack_states`) through that buffer, one select for all."""
        groups = {}
        for j, i in enumerate(indices):
            self._update_count(i)
            key = self._get_lr_wd(i) + (self._index_update_count[i],)
            groups.setdefault(key, []).append(j)
        for (lr, wd, t), js in groups.items():
            gs = torch._foreach_mul(_f32([grads[j] for j in js]),
                                    self.rescale_grad)
            if self.clip_gradient is not None:
                torch._foreach_clamp_min_(gs, -self.clip_gradient)
                torch._foreach_clamp_max_(gs, self.clip_gradient)
            masters = [self._has_master(weights[j]) for j in js]
            ws = [states[j][0] if m else weights[j]
                  if weights[j].dtype == torch.float32 else weights[j].float()
                  for j, m in zip(js, masters)]
            rule_states = [states[j][1:] if m else states[j]
                           for j, m in zip(js, masters)]
            if skip is not None:
                # what the rule changes in place: f32 weights and states
                held = _buffers(
                    [w for j, w in zip(js, ws) if w is weights[j]]
                    + [s for j in js for s in states[j]])
                before = _snapshot(held)
            self._update(ws, gs, rule_states, lr, wd, t)
            if skip is not None:
                for now, was in zip(held, before):
                    torch.where(skip, was, now, out=now)
            # a weight with a master is its master cast: the old weight
            # where skipped, as every update leaves weight == master's cast
            cast = [(weights[j], w) for j, w, m in zip(js, ws, masters) if m]
            if cast:
                torch._foreach_copy_(*map(list, zip(*cast)))
            for j, w, m in zip(js, ws, masters):
                if m or w is weights[j]:
                    continue
                if skip is not None:
                    torch.where(skip, weights[j], w.to(weights[j].dtype),
                                out=weights[j])
                else:
                    weights[j].copy_(w)
        return states


def pack_states(states):
    """`states` (tuples of tensors, or None) with every tensor made a view
    of one contiguous buffer per dtype and device, values copied: the
    rules still run on the views, and a skipped update snapshots and
    selects each buffer with one launch instead of one a tensor."""
    groups = {}
    for st in states:
        for s in st or ():
            groups.setdefault((s.dtype, s.device), []).append(s)
    views = {}
    for ts in groups.values():
        flat = torch.cat([s.reshape(-1) for s in ts])
        for s, v in zip(ts, flat.split([s.numel() for s in ts])):
            views[id(s)] = v.view(s.shape)
    return [None if st is None else tuple(views[id(s)] for s in st)
            for st in states]


def _buffers(tensors):
    """`tensors` with every view of a buffer replaced by that buffer, once:
    what to snapshot and select back to cover them all."""
    out, seen = [], set()
    for t in tensors:
        b = t if t._base is None else t._base
        if id(b) not in seen:
            seen.add(id(b))
            out.append(b)
    return out


def _f32(tensors):
    """`tensors` as f32: those of another dtype copied, in one
    multi-tensor copy."""
    out = [t if t.dtype == torch.float32 else
           torch.empty(t.shape, dtype=torch.float32, device=t.device)
           for t in tensors]
    low = [(o, t) for o, t in zip(out, tensors) if o is not t]
    if low:
        torch._foreach_copy_(*map(list, zip(*low)))
    return out


def _snapshot(tensors):
    """Copies of `tensors`, bit for bit (one multi-tensor copy a dtype)."""
    out = [torch.empty_like(t) for t in tensors]
    by_dtype = {}
    for o, t in zip(out, tensors):
        by_dtype.setdefault(t.dtype, ([], []))
        by_dtype[t.dtype][0].append(o)
        by_dtype[t.dtype][1].append(t)
    for dst, src in by_dtype.values():
        torch._foreach_copy_(dst, src)
    return out


@register("sgd")
class SGD(Optimizer):
    """w -= lr * (g + wd*w), or with momentum: mom = momentum*mom -
    lr*(g + wd*w); w += mom."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return (self._zeros(weight),) if self.momentum != 0.0 else ()

    def _update(self, ws, gs, states, lr, wd, t):
        if wd:
            torch._foreach_add_(gs, ws, alpha=wd)
        torch._foreach_mul_(gs, lr)
        if self.momentum != 0.0:
            moms = [s[0] for s in states]
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)
        else:
            torch._foreach_sub_(ws, gs)


def _moments(states, gs, beta1, beta2):
    ms, vs = [s[0] for s in states], [s[1] for s in states]
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - beta1))
    torch._foreach_mul_(vs, beta2)
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(vs, sq)
    return ms, vs


@register("adam")
class Adam(Optimizer):
    """Adam with the weight decay added to the gradient before the moments,
    bias correction by the parameter's own t, and epsilon outside
    sqrt(v_hat)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _steps(self, ms, vs, t):
        """m_hat / (sqrt(v_hat) + eps), from the updated moments."""
        steps = torch._foreach_div(ms, 1 - self.beta1 ** t)
        den = torch._foreach_div(vs, 1 - self.beta2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(steps, den)
        return steps

    def _update(self, ws, gs, states, lr, wd, t):
        if wd:
            torch._foreach_add_(gs, ws, alpha=wd)
        steps = self._steps(*_moments(states, gs, self.beta1, self.beta2), t)
        torch._foreach_mul_(steps, lr)
        torch._foreach_sub_(ws, steps)


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr * (step + wd*w)."""

    def _update(self, ws, gs, states, lr, wd, t):
        steps = self._steps(*_moments(states, gs, self.beta1, self.beta2), t)
        if wd:
            torch._foreach_add_(steps, ws, alpha=wd)
        torch._foreach_mul_(steps, lr)
        torch._foreach_sub_(ws, steps)
