"""Losses as ``torch.nn.Module``s: the part of
``incubator_mxnet_tpu/gluon/loss.py`` that training the causal LM needs.

Same semantics as the JAX package: per-sample losses, averaged over every
axis except ``batch_axis``, rescaled by ``weight`` and an optional
``sample_weight``.
"""
from __future__ import annotations

from torch import nn

from .. import ops

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


class Loss(nn.Module):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy over `axis` against int class ids
    (``sparse_label``) or distributions; ``from_logits`` takes `pred` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
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
