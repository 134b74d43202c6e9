"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer/__init__.py``):
``Optimizer``, ``create``, the learning-rate schedulers
(:mod:`.lr_scheduler`) and the rules ``sgd``, ``nag``, ``signum``,
``adam``, ``adamw``, ``adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``lamb``, ``dcasgd``, ``adamax``, ``nadam``, ``ftml``, ``lars`` and
``sgld``: all sixteen of the JAX package's.

The arithmetic is the JAX package's, step for step: the gradient is cast
to f32, multiplied by ``rescale_grad`` and clipped to ``clip_gradient``;
the rule then runs in f32 on an f32 view of the weight, and the result is
cast back to the weight's dtype. Each index keeps its own update count
``t`` (bias correction uses it) and the optimizer the largest of them,
``num_update``. A parameter's ``lr_mult``/``wd_mult`` attributes, where
set, scale its learning rate and weight decay. With ``lr_scheduler=`` the
scheduler's ``base_lr`` becomes ``learning_rate``, and ``learning_rate``
reads the schedule at ``num_update``.

Multi-precision: with ``multi_precision=True`` a bf16 or f16 weight keeps
an f32 master copy as the first entry of its state
(:meth:`Optimizer.create_state_multi_precision`); the rule runs on the
master and the weight becomes the master cast to its dtype, so updates
smaller than half a bf16 step accumulate instead of being lost.

Each rule is written once, over lists of tensors with ``torch._foreach_*``
ops, and takes ``lr``, ``wd`` and ``t`` either as Python numbers or as 0-d
f32 tensors on the weights' device; with tensors no op reads a value back
to the host, so a rule can run inside a captured CUDA graph. Two entries
apply it: ``update_multi`` (the Trainer's) to every parameter that shares
a learning rate, weight decay and count, in one multi-tensor launch per
op, and ``update_fused`` (the fused train step's, JAX's
``fused_update``) to every parameter with one device ``lr`` and ``t``,
grouped by ``lr_mult`` and ``wd_mult``; ``update`` is a list of one.
Where the JAX package returns new arrays, the port updates the weight and
the state in place (``torch.no_grad``). The state is f32 on the
parameter's device. ``rescale_grad`` may be a 0-d tensor on that device,
and ``skip`` (the AMP overflow flag) a 0-d bool there: a skipped update
leaves weights, masters and states bit-unchanged, with nothing read back
to the host. The Trainer packs every state into one buffer
(:func:`pack_states`), so the snapshot and the select of a skip are one
launch each for all of them. SGLD draws its noise on each weight's
device from that device's seeded generator (:func:`random.generator`)
and keeps the per-parameter path, as the JAX package's does: it has no
rule for ``update_fused``, so the fused train step refuses it
(:meth:`Optimizer.supports_fused`).
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from . import lr_scheduler

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "Adam", "AdamW", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "LAMB", "DCASGD", "Adamax",
           "Nadam", "FTML", "LARS", "SGLD", "create", "register",
           "pack_states",
           "lr_scheduler"]

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
                 clip_gradient=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            # the JAX package's rule (and its quirk): the scheduler's
            # base_lr becomes learning_rate, its warmup_final_lr stays
            lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.param_dict = param_dict or {}

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
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

    def supports_fused(self) -> bool:
        """Whether :meth:`update_fused` runs the rule (the fused train
        step's condition): every rule but SGLD, whose per-call draw keeps
        the per-parameter path, as in the JAX package."""
        return True

    def _update(self, ws, gs, states, lr, wd, t):
        """The rule, in place on the f32 weights `ws` and the states; `gs`
        are the rescaled, clipped f32 gradients and may be overwritten.
        `lr`, `wd` and `t` are Python numbers or 0-d f32 tensors on the
        weights' device."""
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
            self._apply(js, weights, grads, states, lr, wd, t,
                        self.rescale_grad, skip)
        return states

    @torch.no_grad()
    def update_fused(self, weights, grads, states, lr, wd, t, lr_mults,
                     wd_mults, rescale=None):
        """The fused train step's update (the JAX package's
        ``fused_update``): every weight (in place) from its gradient with
        one learning rate `lr` and count `t`, both 0-d f32 tensors on the
        weights' device (or Python numbers), and a weight decay `wd`;
        parameter j uses ``lr * lr_mults[j]`` and ``wd * wd_mults[j]``, and
        the parameters of one pair of multipliers go through the rule
        together. The gradients are scaled by `rescale` (a number or a 0-d
        tensor; default ``rescale_grad``). Counts no update: the caller
        owns ``num_update``. Returns the states."""
        rescale = self.rescale_grad if rescale is None else rescale
        groups = {}
        for j, key in enumerate(zip(lr_mults, wd_mults)):
            groups.setdefault(key, []).append(j)
        for (lr_mult, wd_mult), js in groups.items():
            self._apply(js, weights, grads, states,
                        lr if lr_mult == 1 else lr * lr_mult,
                        wd if wd_mult == 1 else wd * wd_mult, t, rescale)
        return states

    def _apply(self, js, weights, grads, states, lr, wd, t, rescale,
               skip=None):
        """The rule on the parameters `js`: gradients cast to f32, scaled
        and clipped; the rule on the masters or f32 views; weights written
        back; under `skip`, everything selected back where it is true."""
        gs = torch._foreach_mul(_f32([grads[j] for j in js]), rescale)
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
        # a weight with a master is its master cast: the old weight where
        # skipped, as every update leaves weight == master's cast
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


def _axpy_(xs, ys, a):
    """``xs += a * ys`` for a Python number or a 0-d tensor `a` (given as
    ``alpha=``, a tensor would be read back to the host)."""
    if isinstance(a, torch.Tensor):
        torch._foreach_add_(xs, torch._foreach_mul(ys, a))
    elif a:
        torch._foreach_add_(xs, ys, alpha=a)


def _in_f64(fn, t):
    """``fn(t)`` for a Python number `t`; for a 0-d tensor `t`, `fn`
    evaluated in f64 on the device and rounded to f32 once, as a Python
    number is where an op takes it (``1 - 0.999 ** t`` in f32 loses bits
    to the cancellation)."""
    if isinstance(t, torch.Tensor):
        return fn(t.double()).float()
    return fn(t)


def _ema_(xs, ys, beta):
    """``xs = beta * xs + (1 - beta) * ys``."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, ys, alpha=1 - beta)


def _ema_sq_(xs, ys, beta):
    """``xs = beta * xs + (1 - beta) * ys * ys``."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_addcmul_(xs, ys, ys, value=1 - beta)


def _col(states, i):
    return [s[i] for s in states]


def _norms(tensors):
    """The L2 norm of each tensor, as one (n,) tensor."""
    return torch.stack(torch._foreach_norm(tensors))


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
        _axpy_(gs, ws, wd)
        torch._foreach_mul_(gs, lr)
        if self.momentum != 0.0:
            moms = _col(states, 0)
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)
        else:
            torch._foreach_sub_(ws, gs)


@register("sgld")
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: ``w - lr/2 * (g + wd*w) +
    sqrt(lr) * N(0, 1)`` in f32, cast back to the weight's dtype (a master
    under ``multi_precision`` is left alone, as in the JAX package). The
    noise is drawn on the weight's device from its seeded generator
    (:func:`random.generator`), nothing read back to the host; a skipped
    update leaves the weight bit-unchanged. No state. One parameter at a
    time, as the JAX package's eager ``update``: there is no fused
    form."""

    def supports_fused(self) -> bool:
        return False

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states, skip=None):
        for i, w, g in zip(indices, weights, grads):
            self._update_count(i)
            lr, wd = self._get_lr_wd(i)
            g = g.float() * self.rescale_grad
            if self.clip_gradient is not None:
                g.clamp_(-self.clip_gradient, self.clip_gradient)
            w32 = w.float()
            if wd:
                g.add_(w32, alpha=wd)
            noise = torch.randn(w.shape, generator=_random.generator(
                w.device), device=w.device)
            new = (w32 - lr / 2 * g + math.sqrt(lr) * noise).to(w.dtype)
            if skip is not None:
                new = torch.where(skip, w, new)
            w.copy_(new)
        return states


@register("nag")
class NAG(SGD):
    """Nesterov SGD: mom = momentum*mom - lr*g; w += momentum*mom - lr*g
    (g with the weight decay in)."""

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        torch._foreach_mul_(gs, lr)
        if self.momentum != 0.0:
            moms = _col(states, 0)
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms, alpha=self.momentum)
        torch._foreach_sub_(ws, gs)


@register("signum")
class Signum(Optimizer):
    """Sign of the momentum (or of the gradient without one); `wd_lh`
    decays the weight apart from the step."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return (self._zeros(weight),) if self.momentum != 0.0 else ()

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        if self.momentum != 0.0:
            moms = _col(states, 0)
            _ema_(moms, gs, self.momentum)
            steps = torch._foreach_sign(moms)
            if self.wd_lh:
                torch._foreach_mul_(ws, 1 - lr * self.wd_lh)
        else:
            steps = torch._foreach_sign(gs)
        torch._foreach_mul_(steps, lr)
        torch._foreach_sub_(ws, steps)


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

    def _moments(self, states, gs):
        ms, vs = _col(states, 0), _col(states, 1)
        _ema_(ms, gs, self.beta1)
        _ema_sq_(vs, gs, self.beta2)
        return ms, vs

    def _steps(self, ms, vs, t):
        """m_hat / (sqrt(v_hat) + eps), from the updated moments."""
        steps = torch._foreach_div(ms, _in_f64(lambda t: 1 - self.beta1 ** t, t))
        den = torch._foreach_div(vs, _in_f64(lambda t: 1 - self.beta2 ** t,
                                             t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(steps, den)
        return steps

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        steps = self._steps(*self._moments(states, gs), t)
        torch._foreach_mul_(steps, lr)
        torch._foreach_sub_(ws, steps)


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr * (step + wd*w)."""

    def _update(self, ws, gs, states, lr, wd, t):
        steps = self._steps(*self._moments(states, gs), t)
        _axpy_(steps, ws, wd)
        torch._foreach_mul_(steps, lr)
        torch._foreach_sub_(ws, steps)


@register("adagrad")
class AdaGrad(Optimizer):
    """hist += g*g; w -= lr * g / (sqrt(hist) + eps)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return (self._zeros(weight),)

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        hist = _col(states, 0)
        torch._foreach_addcmul_(hist, gs, gs)
        den = torch._foreach_sqrt(hist)
        torch._foreach_add_(den, self.float_stable_eps)
        torch._foreach_mul_(gs, lr)
        torch._foreach_div_(gs, den)
        torch._foreach_sub_(ws, gs)


@register("adadelta")
class AdaDelta(Optimizer):
    """Running averages of g*g and of the squared steps; the step is
    sqrt(acc_d + eps) / sqrt(acc_g + eps) * g."""

    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        acc_g, acc_d = _col(states, 0), _col(states, 1)
        _ema_sq_(acc_g, gs, self.rho)
        delta = torch._foreach_add(acc_d, self.epsilon)
        torch._foreach_sqrt_(delta)
        den = torch._foreach_add(acc_g, self.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(delta, gs)
        _ema_sq_(acc_d, delta, self.rho)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(ws, delta)


@register("rmsprop")
class RMSProp(Optimizer):
    """n = gamma1*n + (1-gamma1)*g*g; w -= lr * g / (sqrt(n) + eps), or
    ``centered``: the mean gradient's square taken out of n, and a
    momentum gamma2 on the step."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return tuple(self._zeros(weight)
                     for _ in range(3 if self.centered else 1))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        n = _col(states, 0)
        _ema_sq_(n, gs, self.gamma1)
        if self.centered:
            mg = _col(states, 1)
            _ema_(mg, gs, self.gamma1)
            den = torch._foreach_addcmul(n, mg, mg, value=-1.0)
            torch._foreach_add_(den, self.epsilon)
            torch._foreach_sqrt_(den)
        else:
            den = torch._foreach_sqrt(n)
            torch._foreach_add_(den, self.epsilon)
        torch._foreach_mul_(gs, lr)
        torch._foreach_div_(gs, den)
        if self.centered:
            delta = _col(states, 2)
            torch._foreach_mul_(delta, self.gamma2)
            torch._foreach_sub_(delta, gs)
            torch._foreach_add_(ws, delta)
        else:
            torch._foreach_sub_(ws, gs)


@register("ftrl")
class Ftrl(Optimizer):
    """Follow the regularized leader with an L1 term `lamda1`: the weight
    is zero where |z| <= lamda1."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        zs, ns = _col(states, 0), _col(states, 1)
        sq = torch._foreach_mul(gs, gs)
        sigma = torch._foreach_add(ns, sq)
        torch._foreach_sqrt_(sigma)
        torch._foreach_sub_(sigma, torch._foreach_sqrt(ns))
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(zs, gs)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        torch._foreach_add_(ns, sq)
        for w, z, n in zip(ws, zs, ns):
            new = -(z - torch.sign(z) * self.lamda1) / (
                (self.beta + torch.sqrt(n)) / lr)
            w.copy_(torch.where(z.abs() <= self.lamda1, 0.0, new))


@register("lamb")
class LAMB(Optimizer):
    """Adam's step plus the weight decay, scaled per tensor by the trust
    ratio ||w|| / ||step|| (1 where either is zero), clipped to the
    bounds."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        ms, vs = _col(states, 0), _col(states, 1)
        _ema_(ms, gs, self.beta1)
        _ema_sq_(vs, gs, self.beta2)
        if self.bias_correction:
            mhat = torch._foreach_div(
                ms, _in_f64(lambda t: 1 - self.beta1 ** t, t))
            den = torch._foreach_div(
                vs, _in_f64(lambda t: 1 - self.beta2 ** t, t))
        else:
            mhat, den = ms, torch._foreach_mul(vs, 1.0)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        rs = torch._foreach_div(mhat, den)
        _axpy_(rs, ws, wd)
        w_norm, r_norm = _norms(ws), _norms(rs)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        if self.lower_bound is not None:
            ratio = torch.clamp(ratio, min=self.lower_bound)
        if self.upper_bound is not None:
            ratio = torch.clamp(ratio, max=self.upper_bound)
        torch._foreach_mul_(rs, list((lr * ratio).unbind()))
        torch._foreach_sub_(ws, rs)


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated SGD: g + lamda * g * g * (w - previous w), with
    momentum; the state keeps the weight before the update."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        moms, prev = _col(states, 0), _col(states, 1)
        comp = torch._foreach_sub(ws, prev)
        torch._foreach_mul_(comp, gs)
        torch._foreach_mul_(comp, gs)
        torch._foreach_mul_(comp, self.lamda)
        torch._foreach_add_(comp, gs)
        torch._foreach_mul_(comp, lr)
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, comp)
        torch._foreach_copy_(prev, ws)
        torch._foreach_add_(ws, moms)


@register("adamax")
class Adamax(Optimizer):
    """Adam with the infinity norm: u = max(beta2 * u, |g|); w -= lr /
    (1 - beta1^t) * m / (u + eps)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        ms, us = _col(states, 0), _col(states, 1)
        _ema_(ms, gs, self.beta1)
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        den = torch._foreach_add(us, self.epsilon)
        steps = torch._foreach_div(ms, den)
        torch._foreach_mul_(steps,
                            lr / _in_f64(lambda t: 1 - self.beta1 ** t, t))
        torch._foreach_sub_(ws, steps)


@register("nadam")
class Nadam(Optimizer):
    """Adam with Nesterov momentum under the warming schedule
    beta1 * (1 - 0.5 * 0.96^(t * schedule_decay)); each weight keeps the
    product of that schedule, ``m_schedule``, as a 0-d state."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        ms, vs, scheds = _col(states, 0), _col(states, 1), _col(states, 2)
        b1, sd = self.beta1, self.schedule_decay
        mom_t = _in_f64(lambda t: b1 * (1.0 - 0.5 * 0.96 ** (t * sd)), t)
        mom_t1 = _in_f64(
            lambda t: b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd)), t)
        torch._foreach_mul_(scheds, mom_t)
        _ema_(ms, gs, b1)
        _ema_sq_(vs, gs, self.beta2)
        v_corr = _in_f64(lambda t: 1.0 - self.beta2 ** t, t)
        for w, g, m, v, sched in zip(ws, gs, ms, vs, scheds):
            g_prime = g / (1.0 - sched)
            m_prime = m / (1.0 - sched * mom_t1)
            m_bar = (1.0 - mom_t) * g_prime + mom_t1 * m_prime
            w.sub_(lr * m_bar / (torch.sqrt(v / v_corr) + self.epsilon))


@register("ftml")
class FTML(Optimizer):
    """Follow the moving leader: d_t = (1 - beta1^t) / lr * (sqrt(v_hat)
    + eps), z = beta1 z + (1 - beta1) g - (d_t - beta1 d) w, and the new
    weight is -z / d_t."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight), self._zeros(weight),
                self._zeros(weight))

    def _update(self, ws, gs, states, lr, wd, t):
        _axpy_(gs, ws, wd)
        ds, vs, zs = _col(states, 0), _col(states, 1), _col(states, 2)
        _ema_sq_(vs, gs, self.beta2)
        d_t = torch._foreach_div(vs, _in_f64(lambda t: 1 - self.beta2 ** t,
                                             t))
        torch._foreach_sqrt_(d_t)
        torch._foreach_add_(d_t, self.epsilon)
        torch._foreach_mul_(d_t, _in_f64(lambda t: 1 - self.beta1 ** t, t) / lr)
        sigma = torch._foreach_mul(ds, self.beta1)
        torch._foreach_sub_(sigma, d_t)        # beta1 d - d_t = -sigma
        _ema_(zs, gs, self.beta1)
        torch._foreach_addcmul_(zs, sigma, ws)
        torch._foreach_copy_(ds, d_t)
        torch._foreach_copy_(ws, torch._foreach_div(zs, d_t))
        torch._foreach_neg_(ws)


@register("lars")
class LARS(Optimizer):
    """SGD momentum with the step scaled per tensor by the trust ratio
    eta * ||w|| / (||g|| + wd ||w|| + eps) (1 where either norm is
    zero)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, eta=0.001,
                 epsilon=1e-9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (self._zeros(weight),)

    def _update(self, ws, gs, states, lr, wd, t):
        moms = _col(states, 0)
        w_norm, g_norm = _norms(ws), _norms(gs)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon), 1.0)
        _axpy_(gs, ws, wd)
        torch._foreach_mul_(gs, list((trust * lr).unbind()))
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_add_(moms, gs)
        torch._foreach_sub_(ws, moms)
