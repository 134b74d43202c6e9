"""The port's metrics against the JAX package's, on the same numpy labels
and predictions (f64, so both sum in one precision), update after update,
to 1e-6. The port's metrics take tensors and keep their sums as tensors
until ``get()``."""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu_torch import metric as tmetric

N, C = 40, 6


def _batches(seed, n=3):
    """(labels, class probabilities, binary predictions, regression
    targets and values) for `n` updates."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        logits = rng.randn(N, C)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        out.append(dict(
            label=rng.randint(0, C, N).astype(np.float64),
            prob=probs,
            blabel=rng.randint(0, 2, N).astype(np.float64),
            bprob=rng.rand(N, 2),
            target=rng.randn(N),
            value=rng.randn(N, 1),
            loss=rng.rand(N)))
    return out


CASES = {
    "accuracy": (lambda m: m.Accuracy(), "label", "prob"),
    "top_k_accuracy": (lambda m: m.TopKAccuracy(3), "label", "prob"),
    "f1_macro": (lambda m: m.F1(), "blabel", "bprob"),
    "f1_micro": (lambda m: m.F1(average="micro"), "blabel", "bprob"),
    "mcc": (lambda m: m.MCC(), "blabel", "bprob"),
    "mae": (lambda m: m.MAE(), "target", "value"),
    "mse": (lambda m: m.MSE(), "target", "value"),
    "rmse": (lambda m: m.RMSE(), "target", "value"),
    "cross_entropy": (lambda m: m.CrossEntropy(), "label", "prob"),
    "nll": (lambda m: m.NegativeLogLikelihood(), "label", "prob"),
    "perplexity": (lambda m: m.Perplexity(ignore_label=2), "label", "prob"),
    "perplexity_all": (lambda m: m.Perplexity(), "label", "prob"),
    "pearsonr": (lambda m: m.PearsonCorrelation(), "target", "value"),
    "loss": (lambda m: m.Loss(), "label", "loss"),
    "custom": (lambda m: m.np(lambda lab, p: float(np.abs(lab - p).sum()),
                              name="l1"), "target", "loss"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax_update_after_update(case):
    make, lab, pred = CASES[case]
    tm, jm = make(tmetric), make(jmetric)
    for b in _batches(len(case)):
        tm.update([torch.from_numpy(b[lab])], [torch.from_numpy(b[pred])])
        jm.update([b[lab]], [b[pred]])
        (tn, tv), (jn, jv) = tm.get(), jm.get()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6,
                                   err_msg=case)
    tm.reset()
    assert np.isnan(tm.get()[1]) or case in ("mcc",)


def test_create_by_name_and_composite_match_jax():
    b = _batches(7)[0]
    names = ["acc", "ce", "top_k_accuracy", "mae"]
    tm = tmetric.create(["acc", "ce"])
    jm = jmetric.create(["acc", "ce"])
    lab, prob = b["label"], b["prob"]
    tm.update(torch.from_numpy(lab), torch.from_numpy(prob))
    jm.update(lab, prob)
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
    for n in names:
        assert type(tmetric.create(n)).__name__ == type(
            jmetric.create(n)).__name__
    assert tm.get_name_value() == list(zip(*tm.get()))
    with pytest.raises(ValueError, match="Unknown metric"):
        tmetric.create("no_such_metric")


def test_accuracy_keeps_its_sum_on_the_inputs_device_until_get():
    m = tmetric.Accuracy()
    m.update(torch.tensor([1, 0]), torch.tensor([[0.1, 0.9], [0.2, 0.8]]))
    assert isinstance(m.sum_metric, torch.Tensor)
    assert m.get() == ("accuracy", 0.5)


def test_custom_metric_refuses_unmatched_outputs():
    m = tmetric.CustomMetric(lambda lab, p: 0.0)
    assert m.name == "custom(<lambda>)"
    with pytest.raises(ValueError, match="count mismatch"):
        m.update([torch.zeros(2)], [torch.zeros(2), torch.zeros(2)])
