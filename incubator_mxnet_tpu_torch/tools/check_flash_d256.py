#!/usr/bin/env python3
"""The head-dim-256 flash checks of ``chip_smoke.py`` alone, on one card.

    python3 incubator_mxnet_tpu_torch/tools/check_flash_d256.py \\
        [--train] [--out chiprun_out/check_flash_d256]

Builds the two flash sources (printing what ``nvcc -Xptxas -v`` says of
each kernel: registers, spills, stack), then runs ``chip_smoke.check_flash``
and ``chip_smoke.check_flash_bwd`` on the head-dim-256 cases and the padded
D = 192 case only, in f32, bf16 and f16: every kernel against its plain
version, two calls for the same bits, in 16 bits every forward, dQ and
dK/dV launch traced to the wgmma kernel, and each timed (``torch.profiler``
device time) against its bound, its plain version and SDPA. With
``--train`` it then runs chip_smoke's train_lm_d256_bf16 phase
(``train_lm_fused`` at ``chip_smoke.LM_D256`` in bf16) with every check
that phase makes. It prints one line per record and writes them all to
``--out``/records.json, and ptxas's lines to ``--out``/ptxas.txt.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "check_flash_d256"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_d256: no CUDA device")
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    print(cs.gpu_name_and_limit(), flush=True)
    print("build:", _build.build(("flash_attention", "flash_attention_bwd")),
          flush=True)
    dest = Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    ptxas = [f"{name}: {line.strip()}"
             for name, text in _build.logs().items()
             for line in text.splitlines()
             if any(w in line for w in ("registers", "spill", "stack",
                                        "Compiling entry"))]
    (dest / "ptxas.txt").write_text("\n".join(ptxas) + "\n")
    for line in ptxas:
        print("  ptxas " + line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    fwd, bwd = cs.flash_cases, cs.flash_bwd_cases
    cs.flash_cases = lambda: [c for c in fwd() if c[5] == 256]
    cs.flash_bwd_cases = lambda: [c for c in bwd() if c[5] == 256]
    cs.PADDED_CASES = tuple(c for c in cs.PADDED_CASES if c[3] > 128)
    records = []
    cs.check_flash(records)
    cs.check_flash_bwd(records)
    out = {"card": cs.gpu_name_and_limit(), "records": records}
    if args.train:
        out["train"] = cs.train_lm_fused({}, dtype="bfloat16",
                                         label="train_lm_d256_bf16",
                                         **cs.LM_D256)
    out["failed"] = cs.FAILED
    out["seconds"] = time.perf_counter() - t0
    (dest / "records.json").write_text(json.dumps(out, indent=1,
                                                  default=str))
    print(f"check_flash_d256: {len(records)} records, "
          f"{out['seconds']:.1f} s; failed expects: {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
