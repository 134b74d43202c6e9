#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: chip_smoke's bf16
training steps, GPT-2-base by amp's recipe and ResNet-50 by bench.py's.

    python3 incubator_mxnet_tpu_torch/tools/ab_train.py \\
        before=scratch_tree/before new=. [--rounds 2] \\
        [--out chiprun_out/ab_train]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only and builds that root's kernels.
The sides run in order and then in reverse, ``--rounds`` times in all (A,
B, B, A for two sides and two rounds), so that a drift of the card or the
host over the call shows as a difference between rounds.

A side runs, with TF32 off, the root's own

* ``chip_smoke.train_lm`` in bf16 (GPT-2-base, 30 Adam steps at batch 8 x
  512: the module cast to bf16, ``multi_precision=True``, a
  DynamicLossScaler, every ``trainer.step`` under sync debug mode
  "error"), and
* ``chip_smoke.train_resnet`` in bf16 (``resnet50_v1_bnrelu``, 30 SGD steps
  at batch 128 x 224 x 224, ``multi_precision=True``, no scaler),

with every check those phases make (a side whose check fails stops), and
records each one's median step and its forward, backward and optimizer
parts (CUDA events on the stream), the device time of a traced step by
kind of kernel, and the idle share.

The script writes each side's JSON and log and ``ab.json`` under ``--out``
and prints one line per measurement: every run's value in run order, each
side's quartiles and, with two sides, in how many rounds the second read
lower. ``--report <ab.json>`` prints that report again, without a card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

if __package__:
    from . import _ab
else:                # run as a script: its directory is on sys.path
    import _ab

KEYS = ("step_ms_median", "forward_ms_median", "backward_ms_median",
        "optimizer_ms_median", "step_device_ms", "step_stream_ms",
        "idle_share")


def run_side(root):
    """One side: the root's package and chip_smoke, its two bf16 training
    phases."""
    cs, _ = _ab.import_root(root)
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": _build.build()}
    t0 = time.perf_counter()
    lm = cs.train_lm({}, cs.LM, dtype="bfloat16")
    torch.cuda.empty_cache()
    resnet, _ = cs.train_resnet({}, cs.RESNET, dtype="bfloat16")
    if cs.FAILED:
        raise SystemExit(f"A/B: checks failed: {cs.FAILED}")
    result["phases_s"] = time.perf_counter() - t0
    for name, rec in (("lm", lm), ("resnet", resnet)):
        result[name] = {k: rec[k] for k in KEYS + ("step_by_kind_ms",)}
    return result


def metrics(result):
    """{name: value} of one side's run."""
    m = {}
    for name in ("lm", "resnet"):
        rec = result[name]
        for key in KEYS:
            m[f"{name} bf16 {key}"] = rec[key]
        m[f"{name} bf16 other elementwise device ms"] = (
            rec["step_by_kind_ms"].get("other", 0.0))
    return m


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics,
                    default_out="chiprun_out/ab_train")


if __name__ == "__main__":
    sys.exit(main())
