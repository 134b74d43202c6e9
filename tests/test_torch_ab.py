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


def _side(dq, whole, step, err=1e-6):
    flash = [dict(kernel=k, dtype=dt, ms=ms, short_traces=0,
                  kernels=["k"])
             for dt in ("float32", "bfloat16")
             for k, ms in (("dq", dq), ("dkv", 0.3), ("whole", whole))]
    flash += [dict(kernel="sdpa", dtype=dt, ms=0.385, short_traces=1,
                   kernels=["sdpa_bwd"]) for dt in ("float32", "bfloat16")]
    kinds = {"flash_bwd_dq": 12 * dq, "flash_bwd_dkv": 3.6, "matmul": 60.0}
    return {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "ptxas": ["Used 1"],
            "check_worst": {"float32": err, "bfloat16": 2e-3},
            "flash": flash,
            "step": dict(step_ms_median=step, forward_ms_median=30.0,
                         backward_ms_median=60.0, tokens_per_s=4096 / step,
                         step_device_ms=step - 2.0, step_by_kind_ms=kinds)}


def test_flash_report_from_a_hand_made_ab_json(tmp_path, capsys):
    runs = [("pr5", _side(0.36, 0.74, 100.0)),
            ("new", _side(0.15, 0.40, 96.0)),
            ("new", _side(0.16, 0.41, 97.0, err=3e-6)),
            ("pr5", _side(0.35, 0.75, 95.0))]
    path = tmp_path / "ab.json"
    path.write_text(json.dumps([{"label": lab, **r} for lab, r in runs]))
    assert ab_flash.main(["--report", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["NVIDIA H100 80GB HBM3, 700.00 W",
                       "runs in order: pr5 new new pr5"]
    line = {ln.split(":")[0]: ln for ln in out}
    assert line["whole float32 ms"] == (
        "whole float32 ms: | pr5 0.74, 0.75 | pr5 quartiles 0.74/0.745/0.75 "
        "| new 0.4, 0.41 | new quartiles 0.4/0.405/0.41 | new lower in 2 of 2")
    # the step: lower in round 1 (96 < 100), higher in round 2 (97 > 95);
    # the flash backward's device time a step is 12 dQ + the dK/dV kinds
    assert line["step step_ms_median"].endswith("new lower in 1 of 2")
    assert line["step flash backward device ms"].startswith(
        "step flash backward device ms: | pr5 7.92, 7.8 |")
    assert "short traces: 8 (of 32 times)" in out
    # the worst error of the side's own checks over its runs
    assert ("new: chip_smoke.check_flash_bwd passed in every run; worst "
            "error against the plain versions {'float32': 3e-06, "
            "'bfloat16': 0.002}" in out)
