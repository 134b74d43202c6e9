"""Automatic mixed precision (counterpart of ``incubator_mxnet_tpu/amp.py``).

bf16 has f32's exponent range, so the default ``target_dtype()`` of
"bfloat16" usually needs no loss scaling: casting the module and a
multi-precision optimizer are the whole recipe. The loss scalers (static,
and dynamic with overflow backoff) are there for float16 and for parity.

The counterpart of the JAX package's ``net.cast(dtype)`` is PyTorch's
``module.to(dtype)``: both cast every floating parameter and buffer,
BatchNorm's moving statistics included, and leave integer ones alone.
Recipe::

    amp.init()                                   # target dtype bfloat16
    net.to(torch.bfloat16)                       # bf16 params and compute
    trainer = gluon.Trainer(net, "adam", {"multi_precision": True})
    amp.init_trainer(trainer)                    # dynamic loss scaler
    with autograd.record():
        loss = loss_fn(net(x), y)
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
    trainer.step(batch_size)     # unscales; skips and backs off on overflow

Under a :class:`DynamicLossScaler` the finiteness check, the skip of an
overflowed update, the scale and the count of clean steps all stay on
the parameters' device: ``trainer.step`` reads nothing back to the host,
and reading ``loss_scale`` is the one sync. A static :class:`LossScaler`
reads the finiteness flag back (one sync a step) and does not call the
update on overflow, as the JAX package's static path does.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["init", "target_dtype", "init_trainer", "scale_loss",
           "LossScaler", "DynamicLossScaler", "unscale"]

_state = {"target_dtype": "bfloat16"}


def init(target_dtype="bfloat16"):
    """Enable AMP defaults: bfloat16 or float16."""
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError(f"amp target dtype must be 'bfloat16' or "
                         f"'float16', got {target_dtype!r}")
    _state["target_dtype"] = target_dtype


def target_dtype():
    return _state["target_dtype"]


class LossScaler:
    """Static loss scale."""

    def __init__(self, init_scale=2.0 ** 10):
        self.loss_scale = float(init_scale)

    def update(self, overflow: bool):
        pass


class DynamicLossScaler(LossScaler):
    """Dynamic scaling: halve on overflow (floored at 1, and the update is
    skipped), double after `growth_interval` clean steps.

    Within ``trainer.step`` the scale (f32) and the clean-step count
    (int32) are 0-d tensors on the parameters' device, advanced there by
    :meth:`_device_update`; the optimizer selects the old weights and
    states back where the step overflowed. :meth:`update` is the same
    transition on the host."""

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000):
        self._scale_dev = None
        self._unskipped_dev = None
        super().__init__(init_scale)
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self._unskipped = 0

    @property
    def loss_scale(self):
        if self._scale_dev is not None:
            return float(self._scale_dev)
        return self._loss_scale_host

    @loss_scale.setter
    def loss_scale(self, v):
        self._loss_scale_host = float(v)
        if self._scale_dev is not None:
            self._scale_dev.fill_(self._loss_scale_host)

    def update(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale * self.backoff_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.growth_interval:
                self.loss_scale *= self.growth_factor
                self._unskipped = 0
        if self._unskipped_dev is not None:
            self._unskipped_dev.fill_(self._unskipped)

    def _ensure_device(self, device):
        """Move the state onto `device` once (fills, no host copy)."""
        if self._scale_dev is None:
            self._scale_dev = torch.full((), self._loss_scale_host,
                                         dtype=torch.float32, device=device)
            self._unskipped_dev = torch.full((), self._unskipped,
                                             dtype=torch.int32, device=device)

    @torch.no_grad()
    def _device_update(self, finite):
        """The (scale, count) transition from the on-device bool `finite`,
        in place on the device."""
        scale, unskipped = self._scale_dev, self._unskipped_dev
        grown = unskipped + 1 >= self.growth_interval
        new_scale = torch.where(
            finite, torch.where(grown, scale * self.growth_factor, scale),
            torch.clamp_min(scale * self.backoff_factor, 1.0))
        new_unskipped = torch.where(
            finite, torch.where(grown, torch.zeros_like(unskipped),
                                unskipped + 1), torch.zeros_like(unskipped))
        scale.copy_(new_scale)
        unskipped.copy_(new_unskipped)


def _grads(params):
    """The gradients present (parameters without one this step are
    skipped, as a stale gradient is)."""
    return [p.grad for p in params if p.grad is not None]


@torch.no_grad()
def _grads_finite_device(params):
    """Whether every gradient's f32 sum of magnitudes is finite: a 0-d
    bool on the parameters' device, never read back here. One multi-tensor
    L1 norm a dtype (``torch._foreach_norm``, f32 sums; the card's
    ``_amp_foreach_non_finite_check_and_unscale_`` takes no bf16). The JAX
    package sums each gradient in f32 instead; the two differ only where
    finite gradients sum past f32's range."""
    by_dtype = {}
    for g in _grads(params):
        by_dtype.setdefault(g.dtype, []).append(g)
    if not by_dtype:
        return torch.ones((), dtype=torch.bool, device=params[0].device)
    norms = [n for gs in by_dtype.values()
             for n in torch._foreach_norm(gs, 1, dtype=torch.float32)]
    return torch.isfinite(torch.stack(norms)).all()


def init_trainer(trainer, scaler: LossScaler | None = None):
    """Attach a loss scaler (default :class:`DynamicLossScaler`) and wrap
    ``trainer.step`` and ``trainer.update``: the gradients are unscaled
    inside the update (``rescale_grad = (1 / scale) / batch_size``), and
    an overflowed step is skipped.

    A dynamic scaler keeps the check and the skip on the device: the
    update runs unconditionally and selects the old weights and states
    back where a gradient was not finite (and sets the gradients to None,
    as after any update), and the scale backs off or grows there too. Its
    skipped step counts as an update for the optimizer's ``t``, as the
    JAX package's dynamic path counts it.

    A static scaler branches on the host, as the JAX package's static
    path does: an overflowed step calls no update, so the weights, the
    states and the optimizer's ``t`` stay as they were; its gradients are
    dropped (set to None), and the next backward writes afresh."""
    scaler = scaler or DynamicLossScaler()
    trainer._amp_loss_scaler = scaler
    trainer._amp_unscaled = False
    dynamic = isinstance(scaler, DynamicLossScaler)

    def wrap(orig):
        def amp_call(batch_size, ignore_stale_grad=False):
            if dynamic:
                scaler._ensure_device(trainer._params[0].device)
            finite = _grads_finite_device(trainer._params)
            if not dynamic and not bool(finite):
                for p in trainer._params:
                    p.grad = None
                trainer._amp_unscaled = False
                scaler.update(True)
                return
            trainer._amp_skip = (torch.logical_not(finite) if dynamic
                                 else None)
            trainer._scale = (1.0 if trainer._amp_unscaled
                              else 1.0 / _scale_of(trainer))
            try:
                orig(batch_size, ignore_stale_grad)
            finally:
                trainer._scale = 1.0
                trainer._amp_skip = None
            trainer._amp_unscaled = False
            if dynamic:
                scaler._device_update(finite)
            else:
                scaler.update(False)
        return amp_call

    trainer.step = wrap(trainer.step)
    trainer.update = wrap(trainer.update)
    return trainer


def _scale_of(trainer):
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise ValueError("call amp.init_trainer(trainer) first")
    # the device-resident scale where there is one: no host sync
    scale = getattr(scaler, "_scale_dev", None)
    return scaler.loss_scale if scale is None else scale


@contextmanager
def scale_loss(loss, trainer):
    """Yield ``loss * scale`` (a list or tuple of losses each scaled); the
    step of a trainer wrapped by :func:`init_trainer` divides the
    gradients back by the scale."""
    scale = _scale_of(trainer)
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scale for l in loss)
    else:
        yield loss * scale


@torch.no_grad()
def unscale(trainer):
    """Divide the current gradients by the loss scale (in f32, cast back to
    each gradient's dtype), for clipping between backward and step. The
    next ``step``/``update`` does not unscale again; the scaler's state is
    untouched."""
    inv = 1.0 / _scale_of(trainer)
    for g in _grads(trainer._params):
        g.copy_(g.float() * inv)
    trainer._amp_unscaled = True
