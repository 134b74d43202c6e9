#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: chip_smoke's Gluon
phase, ResNet-50 v1 trained and served the MXNet way, then BERT-base
hybridized.

    python3 incubator_mxnet_tpu_torch/tools/ab_gluon.py \\
        before=scratch_tree/before new=. [--rounds 2] \\
        [--out chiprun_out/ab_gluon]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only and builds that root's kernels.
The sides run in order and then in reverse, ``--rounds`` times in all (A,
B, B, A for two sides and two rounds), so that a drift of the card or the
host over the call shows as a difference between rounds.

A side runs the root's own ``chip_smoke.gluon_resnet`` (TF32 off, cuDNN
deterministic, as ``chip_smoke.main`` runs it), with every check it makes
(a side whose check fails stops), and records its median eager training
step at batch 128, the batch-32 forward hybridized and eager, the first
forward that completes the deferred shapes, and, where the root's phase
times them, BERT-base's eager forward and replay at 8 x 128. A root whose
phase passes tensors and one whose phase passes NDArrays (``nd``) time the
same network on the same batches.

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

KEYS = ("step_ms_median", "hybrid_forward_ms_b32", "eager_forward_ms_b32",
        "first_forward_s", "bert_eager_forward_ms", "bert_replay_ms")


def run_side(root):
    """One side: the root's package and chip_smoke, its Gluon phase."""
    cs, _ = _ab.import_root(root)
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": _build.build()}
    torch.backends.cudnn.deterministic = True
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)   # the phase saves there
    t0 = time.perf_counter()
    summary = cs.gluon_resnet({})
    result["phase_s"] = time.perf_counter() - t0
    result["through"] = summary.get("through", "tensor")
    result.update({k: summary.get(k) for k in KEYS})
    return result


def metrics(result):
    """{name: value} of one side's run."""
    return {k: result[k] for k in KEYS}


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics,
                    default_out="chiprun_out/ab_gluon")


if __name__ == "__main__":
    sys.exit(main())
