"""Losses as Gluon blocks (counterpart of ``incubator_mxnet_tpu/gluon/
loss.py``): the part that training the causal LM needs.

:class:`Loss` is a :class:`~.block.HybridBlock`, as in the JAX package, so
a loss takes ``hybridize()``, ``collect_params()`` (empty: a loss has no
parameters) and ``initialize()`` like any other block. Same semantics as
the JAX package: per-sample losses, averaged over every axis except
``batch_axis``, rescaled by ``weight`` and an optional ``sample_weight``.

A hybridized loss called on the card outside ``autograd.record()`` runs
from one CUDA graph per input signature (``HybridBlock``'s path). Under
``record()``, and inside another capture (``FusedTrainStep``'s step, whose
loss runs under ``record()``, ``FrozenModel``'s bucket, an outer block's),
it runs op by op, so it never starts a capture inside a capture.
"""
from __future__ import annotations

from .. import ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _reduce(loss, batch_axis):
    """Mean over every axis but `batch_axis`; a 0-D or 1-D loss as it is."""
    if loss.ndim <= 1:
        return loss
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis % loss.ndim)
    return loss.mean(dim=axes)


def _weighted(loss, weight, sample_weight):
    if weight is not None and weight != 1.0:
        loss = loss * weight
    if sample_weight is not None:
        loss = loss * sample_weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight=1.0, batch_axis=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._weight = weight
        self._batch_axis = batch_axis


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy over `axis` against int class ids
    (``sparse_label``) or distributions; ``from_logits`` takes `pred` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0, **kw):
        super().__init__(weight, batch_axis, **kw)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis
        if not self._from_logits:
            loss = ops.softmax_cross_entropy(pred, label, axis, self._sparse)
        elif self._sparse:
            lab = label.to(pred.device).long().unsqueeze(axis)
            loss = -pred.gather(axis, lab).squeeze(axis)
        else:
            loss = -(pred * label).sum(axis)
        loss = _weighted(loss, self._weight, sample_weight)
        return _reduce(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
