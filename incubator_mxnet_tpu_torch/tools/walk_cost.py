#!/usr/bin/env python3
"""What ``autograd.backward``'s walk to the leaves it overwrites costs a
GPT-2-base training step on one card.

    python3 incubator_mxnet_tpu_torch/tools/walk_cost.py [--rounds 2]

``autograd.backward`` gives MXNet's ``grad_req="write"``: before it
backpropagates it walks the heads' graph in Python to every leaf it reaches
and sets the leaf's ``.grad`` to None. In a Trainer loop every gradient is
already None there (the Trainer clears what it applied), so the walk
changes no result and its cost can be read by taking it out. The script
runs ``chip_smoke.train_lm`` in f32 (20 steps, every check that phase
makes) three ways, in turn and then in reverse, ``--rounds`` times:
``walk`` (as shipped), ``nowalk`` (the walk replaced by one that finds no
leaf) and ``walk_nogc`` (as shipped, Python's cyclic garbage collector
off, to show what of the cost is the collections the walk's allocations
bring on). It prints each run's medians of step, forward, backward and
optimizer ms (CUDA events on the stream, after a synchronise) and the
walk alone on a step's graph, then one JSON line of them all.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("walk_cost: no CUDA device")
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    _build.build(("flash_attention", "flash_attention_bwd", "layer_norm"))
    real = autograd._reached_leaves
    modes = ["walk", "nowalk", "walk_nogc"]
    res = {}
    try:
        for rnd in range(args.rounds):
            for mode in modes if rnd % 2 == 0 else modes[::-1]:
                autograd._reached_leaves = (
                    real if mode != "nowalk" else (lambda heads: []))
                if mode == "walk_nogc":
                    gc.disable()
                try:
                    s = cs.train_lm({}, dict(cs.LM, steps=20))
                finally:
                    gc.enable()
                r = {k: s[k] for k in (
                    "step_ms_median", "forward_ms_median",
                    "backward_ms_median", "optimizer_ms_median",
                    "backward_leaf_walk_ms")}
                res.setdefault(mode, []).append(r)
                print(mode, json.dumps(r), flush=True)
                torch.cuda.empty_cache()
    finally:
        autograd._reached_leaves = real
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
