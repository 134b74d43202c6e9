"""The report of the port's A/B tools, from a small hand-made ab.json: the
quartiles of each side and the count of rounds in which the second side read
lower. The measurements themselves run only on the card."""
import json

import pytest

from incubator_mxnet_tpu_torch.tools import _ab, ab_flash


def test_quartiles_are_the_sorted_values_at_n_over_4_and_3n_over_4():
    assert _ab.quartiles([4.0, 1.0, 3.0, 2.0]) == (2.0, 2.5, 4.0)
    assert _ab.quartiles([5.0, 1.0, 3.0]) == (1.0, 3.0, 5.0)
    assert _ab.quartiles([7.0]) == (7.0, 7.0, 7.0)


@pytest.mark.parametrize("values,lower", [
    # (old, new) per round, in run order old new | new old | old new
    ([1.0, 0.5, 0.6, 1.1, 1.2, 0.7], 3),
    ([1.0, 0.5, 1.2, 1.1, 1.2, 0.7], 2),    # round 2: new read higher
    ([1.0, 1.0, 0.6, 1.1, 1.2, None], 1),   # a tie, a null: neither
])
def test_rounds_lower_pairs_runs_in_order(values, lower):
    labels = ["old", "new", "new", "old", "old", "new"]
    runs = [(lab, {"x": v}) for lab, v in zip(labels, values)]
    assert _ab.rounds_lower(runs, "x", ["old", "new"]) == (lower, 3)


def _side(dq, whole, step, err=1e-6, fwd=0.19):
    flash = [dict(kernel=k, dtype=dt, ms=ms, short_traces=0,
                  kernels=["k"])
             for dt in ("float32", "bfloat16")
             for k, ms in (("fwd_bert_b8", fwd / 7), ("fwd_lm", fwd),
                           ("dq", dq), ("dkv", 0.3), ("whole", whole))]
    flash += [dict(kernel=k, dtype=dt, ms=ms, short_traces=1,
                   kernels=[k + "_kernel"])
              for dt in ("float32", "bfloat16")
              for k, ms in (("sdpa_fwd_bert_b8", 0.0223),
                            ("sdpa_fwd_lm", 0.164), ("sdpa", 0.385))]
    kinds = {"flash_attention": 12 * fwd, "flash_bwd_dq": 12 * dq,
             "flash_bwd_dkv": 3.6, "matmul": 60.0}
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "ptxas": ["Used 1"],
            "check_fwd_worst": {"float32": err / 2, "bfloat16": 4e-3},
            "check_worst": {"float32": err, "bfloat16": 2e-3},
            "flash": flash,
            "step": dict(step_ms_median=step, forward_ms_median=30.0,
                         backward_ms_median=60.0, tokens_per_s=4096 / step,
                         step_device_ms=step - 2.0, step_by_kind_ms=kinds)}


def test_flash_report_from_a_hand_made_ab_json(tmp_path, capsys):
    runs = [("parent", _side(0.36, 0.74, 100.0)),
            ("new", _side(0.15, 0.40, 96.0, fwd=0.11)),
            ("new", _side(0.16, 0.41, 97.0, err=3e-6, fwd=0.12)),
            ("parent", _side(0.35, 0.75, 95.0))]
    path = tmp_path / "ab.json"
    path.write_text(json.dumps([{"label": lab, **r} for lab, r in runs]))
    assert ab_flash.main(["--report", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["NVIDIA H100 80GB HBM3, 700.00 W",
                       "runs in order: parent new new parent"]
    line = {ln.split(":")[0]: ln for ln in out}
    assert line["whole float32 ms"] == (
        "whole float32 ms: | parent 0.74, 0.75 | parent quartiles "
        "0.74/0.745/0.75 "
        "| new 0.4, 0.41 | new quartiles 0.4/0.405/0.41 | new lower in 2 of 2")
    # the step: lower in round 1 (96 < 100), higher in round 2 (97 > 95);
    # the flash backward's device time a step is 12 dQ + the dK/dV kinds
    assert line["step step_ms_median"].endswith("new lower in 1 of 2")
    assert line["step flash backward device ms"].startswith(
        "step flash backward device ms: | parent 7.92, 7.8 |")
    # the forward at both shapes, and its device time a step (12 launches)
    assert line["fwd_lm float32 ms"] == (
        "fwd_lm float32 ms: | parent 0.19, 0.19 | parent quartiles "
        "0.19/0.19/0.19 "
        "| new 0.11, 0.12 | new quartiles 0.11/0.115/0.12 | new lower in 2 "
        "of 2")
    assert line["fwd_bert_b8 bfloat16 ms"].endswith("new lower in 2 of 2")
    assert line["sdpa_fwd_lm float32 ms"].endswith("new lower in 0 of 2")
    assert line["step flash forward device ms"].startswith(
        "step flash forward device ms: | parent 2.28, 2.28 | parent quartiles "
        "2.28/2.28/2.28 | new 1.32, 1.44 |")
    assert "short traces: 24 (of 64 times)" in out
    # the worst error of the side's own checks over its runs
    assert ("new: chip_smoke.check_flash_bwd passed in every run; worst "
            "error against the plain versions {'float32': 3e-06, "
            "'bfloat16': 0.002}" in out)
    assert ("new: chip_smoke.check_flash passed in every run; worst "
            "error against the plain versions {'float32': 1.5e-06, "
            "'bfloat16': 0.004}" in out)
    assert ("parent: SDPA's forward launches {'float32': "
            "['sdpa_fwd_lm_kernel'], 'bfloat16': ['sdpa_fwd_lm_kernel']}"
            in out)


def _train_side(lm_opt, resnet_opt):
    def rec(opt, fwd, bwd):
        return dict(step_ms_median=fwd + bwd + opt, forward_ms_median=fwd,
                    backward_ms_median=bwd, optimizer_ms_median=opt,
                    step_device_ms=0.6 * (fwd + bwd + opt),
                    step_stream_ms=0.8 * (fwd + bwd + opt), idle_share=0.25,
                    step_by_kind_ms={"other": opt, "matmul": 11.0})
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "lm": rec(lm_opt, 16.0, 28.0), "resnet": rec(resnet_opt, 31.0,
                                                          69.0)}


def test_train_report_from_a_hand_made_ab_json(tmp_path, capsys):
    from incubator_mxnet_tpu_torch.tools import ab_train
    runs = [("before", _train_side(24.0, 5.0)),
            ("new", _train_side(14.0, 4.0)),
            ("new", _train_side(15.0, 4.5)),
            ("before", _train_side(23.0, 4.4))]
    path = tmp_path / "ab.json"
    path.write_text(json.dumps([{"label": lab, **r} for lab, r in runs]))
    assert ab_train.main(["--report", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    line = {ln.split(":")[0]: ln for ln in out}
    assert line["lm bf16 optimizer_ms_median"] == (
        "lm bf16 optimizer_ms_median: | before 24, 23 | before "
        "quartiles 23/23.5/24 | new 14, 15 | new quartiles 14/14.5/15 | "
        "new lower in 2 of 2")
    # round 2: 4.5 against 4.4, the new side higher
    assert line["resnet bf16 optimizer_ms_median"].endswith(
        "new lower in 1 of 2")
    assert line["lm bf16 other elementwise device ms"].endswith(
        "new lower in 2 of 2")


def test_rounds_lower_takes_a_round_as_one_run_of_each_side():
    # three sides, in run order a b c | c b a: b reads lower than a in
    # round 1 only, c in both
    labels = ["a", "b", "c", "c", "b", "a"]
    values = [1.0, 0.5, 0.2, 0.3, 1.5, 1.2]
    runs = [(lab, {"x": v}) for lab, v in zip(labels, values)]
    assert _ab.rounds_lower(runs, "x", ["a", "b"]) == (1, 2)
    assert _ab.rounds_lower(runs, "x", ["a", "c"]) == (2, 2)


def _ln_side(kernel_ms, launches, replay_ms, ln_ms):
    from incubator_mxnet_tpu_torch.tools import ab_layer_norm
    recs = [dict(case=case, rows=rows, d=d, dtype=dt, max_abs_err=kernel_ms,
                 kernel_ms=kernel_ms, call_ms=kernel_ms * launches,
                 launches=launches, short_traces=0,
                 kernels=[f"ln_kernel<{dt}>"], bound_ms=rows * d * 1e-9)
            for case, rows, d, dt in ab_layer_norm.cases()]
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "ptxas": ["Used 79"],
            "layer_norm": recs,
            "bert_b16_bf16": {"device_ms": replay_ms, "stream_ms": 1.3,
                              "kernels_a_replay": 200.0 + 2 * launches,
                              "by_kind_ms": {"layer_norm": ln_ms,
                                             "matmul": 0.67}}}


def test_layer_norm_report_from_a_hand_made_ab_json(tmp_path, capsys):
    from incubator_mxnet_tpu_torch.tools import ab_layer_norm
    runs = [("parent", _ln_side(0.009, 3, 1.25, 0.14)),
            ("new", _ln_side(0.004, 1, 1.15, 0.08)),
            ("new", _ln_side(0.0045, 1, 1.16, 0.08)),
            ("parent", _ln_side(0.0041, 3, 1.24, 0.139))]
    path = tmp_path / "ab.json"
    path.write_text(json.dumps([{"label": lab, **r} for lab, r in runs]))
    assert ab_layer_norm.main(["--report", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    line = {ln.split(":")[0]: ln for ln in out}
    # round 2: 0.0045 against 0.0041, the new side higher
    assert line["rows4096 bfloat16 kernel ms"] == (
        "rows4096 bfloat16 kernel ms: | parent 0.009, 0.0041 | parent "
        "quartiles 0.0041/0.00655/0.009 | new 0.004, 0.0045 | new quartiles "
        "0.004/0.00425/0.0045 | new lower in 1 of 2")
    # a call's device time is every kernel it launched
    assert line["rows2048 bfloat16 call ms"].endswith("new lower in 2 of 2")
    assert line["bert b16 bf16 replay kernels"].startswith(
        "bert b16 bf16 replay kernels: | parent 206, 206 |")
    assert line["bert b16 bf16 replay layer_norm ms"].endswith(
        "new lower in 2 of 2")
    assert line["bert b16 bf16 replay other ms"].startswith(
        "bert b16 bf16 replay other ms: | parent 0, 0 |")
    # every case in both dtypes, with its bound; no short trace
    n = len(ab_layer_norm.cases())
    assert len([k for k in line if k.endswith(" kernel ms")]) == n == 20
    assert f"short traces: 0 (of {4 * n} times)" in out
    bounds = next(ln for ln in out if ln.startswith("bound ms"))
    assert "rows4096 bfloat16 0.00315" in bounds
    assert ("new: worst error against layer_norm_ref {'float32': 0.0045, "
            "'bfloat16': 0.0045}" in out)
