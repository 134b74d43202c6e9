"""Evaluation metrics (counterpart of ``incubator_mxnet_tpu/metric.py``;
parity: python/mxnet/metric.py).

Labels and predictions are NDArrays or tensors on any device (or numpy
arrays). The
counting metrics keep their sums as f64 tensors on the inputs' device, so
an update launches a few reductions and reads nothing back: the host
reads the sums in ``get()``. ``PearsonCorrelation`` keeps its inputs and
``CustomMetric`` calls its numpy function on host copies. The registry has
the JAX package's names (``create("acc")``, ``create(["acc", "ce"])``).
"""
from __future__ import annotations

import numpy as _numpy
import torch

from .ndarray import _unwrap

__all__ = ["create", "register", "EvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Perplexity", "PearsonCorrelation",
           "Loss", "CompositeEvalMetric", "CustomMetric", "np"]

_REGISTRY = {}


def register(name=None):
    """Class decorator: `create` finds the class under `name` (default its
    class name), lower-cased."""
    def deco(cls):
        _REGISTRY[(name or cls.__name__).lower()] = cls
        return cls
    return deco


def create(name, *args, **kwargs):
    """The metric registered under `name`; a list gives a
    ``CompositeEvalMetric`` of each; a metric passes through."""
    if isinstance(name, list):
        c = CompositeEvalMetric()
        for n in name:
            c.add(create(n, *args, **kwargs))
        return c
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown metric {name!r}. Registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](*args, **kwargs)


def _t(x):
    """A tensor of `x` (an NDArray's; numpy arrays and lists go to the
    CPU)."""
    x = _unwrap(x)
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        _numpy.asarray(x))


def _host(x):
    """`x` as a numpy array (bf16 as float32, as ``NDArray.asnumpy``)."""
    x = _unwrap(x)
    if not isinstance(x, torch.Tensor):
        return _numpy.asarray(x)
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _value(x):
    """A sum as a Python number (a tensor is read back here)."""
    return x.item() if isinstance(x, torch.Tensor) else x


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        n = _value(self.num_inst)
        if n == 0:
            return self.name, float("nan")
        return self.name, float(_value(self.sum_metric) / n)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kw):
        self.axis = axis
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _t(pred), _t(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(dim=self.axis)
            pred = pred.to(torch.int64).reshape(-1)
            label = label.to(torch.int64).reshape(-1).to(pred.device)
            self.sum_metric = self.sum_metric + (pred == label).sum(
                dtype=torch.float64)
            self.num_inst += label.numel()


@register("top_k_accuracy")
@register("topkaccuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kw):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}")

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _t(pred)
            label = _t(label).to(torch.int64).reshape(-1).to(pred.device)
            # ties broken as numpy's argsort(-pred) breaks them: stable, the
            # lower index first
            topk = torch.argsort(-pred, dim=-1, stable=True)[:, :self.top_k]
            self.sum_metric = self.sum_metric + (
                topk == label[:, None]).any(-1).sum(dtype=torch.float64)
            self.num_inst += label.numel()


def _binary(label, pred):
    pred, label = _t(pred), _t(label)
    if pred.ndim > 1:
        pred = pred.argmax(dim=-1)
    return (label.to(torch.int64).reshape(-1).to(pred.device),
            pred.to(torch.int64).reshape(-1))


def _counts(label, pred):
    """(tp, fp, fn, tn) as int64 tensors."""
    p1, l1 = pred == 1, label == 1
    p0, l0 = pred == 0, label == 0
    return ((p1 & l1).sum(), (p1 & l0).sum(), (p0 & l1).sum(),
            (p0 & l0).sum())


@register("f1")
class F1(EvalMetric):
    """average='micro': one F1 from globally pooled counts;
    'macro' (default, reference semantics): mean of per-update F1 scores."""

    def __init__(self, name="f1", average="macro", **kw):
        self.average = average
        super().__init__(name)

    def reset(self):
        self.tp = self.fp = self.fn = 0
        self._batch = []
        self.num_inst = 0
        self.sum_metric = 0.0

    @staticmethod
    def _f1(tp, fp, fn):
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        return 2 * prec * rec / max(prec + rec, 1e-12)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            tp, fp, fn, _ = _counts(*_binary(label, pred))
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.fn = self.fn + fn
            self._batch.append((tp, fp, fn))
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        if self.average == "micro":
            return self.name, self._f1(_value(self.tp), _value(self.fp),
                                       _value(self.fn))
        return self.name, float(_numpy.mean([
            self._f1(*(_value(c) for c in b)) for b in self._batch]))


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kw):
        super().__init__(name)

    def reset(self):
        self.tp = self.fp = self.fn = self.tn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            tp, fp, fn, tn = _counts(*_binary(label, pred))
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.fn = self.fn + fn
            self.tn = self.tn + tn
            self.num_inst += 1

    def get(self):
        tp, fp, fn, tn = (_value(c) for c in (self.tp, self.fp, self.fn,
                                              self.tn))
        num = tp * tn - fp * fn
        den = _numpy.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) *
                                (tn + fn)))
        return self.name, num / den if den else 0.0


def _pair(label, pred):
    pred = _t(pred).to(torch.float64)
    return _t(label).to(pred.device, torch.float64).reshape(pred.shape), pred


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kw):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _pair(label, pred)
            self.sum_metric = self.sum_metric + (label - pred).abs().mean()
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kw):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _pair(label, pred)
            self.sum_metric = self.sum_metric + (label - pred).square().mean()
            self.num_inst += 1


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kw):
        super().__init__(name)

    def get(self):
        name, v = super().get()
        return name, float(_numpy.sqrt(v))


def _picked(label, pred):
    """pred[i, label[i]] in f64 for the rows of `pred` viewed (N, -1)."""
    pred = _t(pred)
    label = _t(label).to(torch.int64).reshape(-1).to(pred.device)
    pred = pred.reshape(label.numel(), -1).to(torch.float64)
    return label, pred.gather(1, label[:, None])[:, 0]


@register("ce")
@register("cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kw):
        self.eps = eps
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, prob = _picked(label, pred)
            self.sum_metric = self.sum_metric + (
                -torch.log(prob + self.eps)).sum()
            self.num_inst += label.numel()


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kw):
        super().__init__(eps, name)


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, name="perplexity", **kw):
        self.ignore_label = ignore_label
        super().__init__(name=name)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, prob = _picked(label, pred)
            mask = (label != self.ignore_label if self.ignore_label is not None
                    else torch.ones_like(label, dtype=torch.bool))
            self.sum_metric = self.sum_metric + torch.where(
                mask, -torch.log(prob + 1e-12), 0.0).sum()
            self.num_inst = self.num_inst + mask.sum()

    def get(self):
        n = _value(self.num_inst)
        if n == 0:
            return self.name, float("nan")
        return self.name, float(_numpy.exp(_value(self.sum_metric) / n))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kw):
        super().__init__(name)

    def reset(self):
        self._labels = []
        self._preds = []
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_t(label).reshape(-1))
            self._preds.append(_t(pred).reshape(-1))
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        lab = _numpy.concatenate([_host(t) for t in self._labels])
        pred = _numpy.concatenate([_host(t) for t in self._preds])
        return self.name, float(_numpy.corrcoef(lab, pred)[0, 1])


@register("loss")
class Loss(EvalMetric):
    """Average of pre-computed per-batch loss values."""

    def __init__(self, name="loss", **kw):
        super().__init__(name)

    def update(self, _, preds):
        for pred in _as_list(preds):
            v = _t(pred)
            self.sum_metric = self.sum_metric + v.sum(dtype=torch.float64)
            self.num_inst += v.numel()


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kw):
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]
        super().__init__(name)

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, vals = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            vals.append(v)
        return names, vals


register("composite")(CompositeEvalMetric)


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred) -> float`` (or ``(sum, count)``), called on
    numpy copies, as a metric (reference metric.CustomMetric;
    ``metric.np(f)`` builds one from a numpy function)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs
        name = name or getattr(feval, "__name__", "custom")
        # the reference wraps only anonymous callables ('<lambda>')
        if "<" in name:
            name = f"custom({name})"
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs and len(labels) != len(preds):
            raise ValueError(
                f"labels/preds count mismatch {len(labels)} vs {len(preds)}"
                " (pass allow_extra_outputs=True to permit)")
        for lab, pred in zip(labels, preds):
            val = self._feval(_host(lab), _host(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


register("custom")(CustomMetric)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` from a numpy ``feval(label, pred)``."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
