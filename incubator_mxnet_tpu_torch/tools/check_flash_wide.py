#!/usr/bin/env python3
"""The head-dim-above-256 checks of ``chip_smoke.py`` alone, on one card.

    python3 incubator_mxnet_tpu_torch/tools/check_flash_wide.py \\
        [--train] [--autograd] [--out chiprun_out/check_flash_wide]

Builds the two flash sources, which include ``csrc/flash_attention_wide.cu``
(printing what ``nvcc -Xptxas -v`` says of the wide kernels,
``flash_fwd_wide_kernel``, ``flash_bwd_dq_wide_kernel`` and
``flash_bwd_dkv_wide_kernel`` in f32, bf16 and f16: registers, spills,
stack), then runs ``chip_smoke.flash_wide``: every wide kernel against its
plain version at every case of ``chip_smoke.wide_cases()`` and D = 257
through the padding Function, in f32 also against the plain version in
float64, two calls for the same bits, every launch traced to the wide
kernel, and at ``chip_smoke.WIDE_TIMED`` each timed (``torch.profiler``
device time) against its bound, its plain version and SDPA, whose backend
is named. With ``--train`` it then runs chip_smoke's train_lm_d512_bf16
and train_lm_d512_f32 phases (``train_lm_fused`` at ``chip_smoke.LM_D512``)
with every check they make; with ``--autograd`` its autograd_api phase. It
prints one line per check and writes the records and summaries to
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
    ap.add_argument("--autograd", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "check_flash_wide"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_wide: no CUDA device")
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
    # each wide kernel's entry line and the lines after it
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and "wide" in line:
            for text in ptxas[i:i + 4]:
                print("  ptxas " + text, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    records = []
    out = {"card": cs.gpu_name_and_limit(), "records": records}
    t = time.perf_counter()
    cs.flash_wide(records)
    out["flash_wide_s"] = time.perf_counter() - t
    print(f"flash_wide: {out['flash_wide_s']:.1f} s", flush=True)
    phases = []
    if args.train:
        phases += [(label, lambda dtype=dtype, label=label: cs.train_lm_fused(
            {}, dtype=dtype, label=label, **cs.LM_D512))
            for dtype, label in (("bfloat16", "train_lm_d512_bf16"),
                                 ("float32", "train_lm_d512_f32"))]
    if args.autograd:
        phases.append(("autograd_api", lambda: cs.autograd_api({})))
    for label, fn in phases:
        t = time.perf_counter()
        out[label] = fn()
        out[label]["phase_s"] = time.perf_counter() - t
        print(f"{label}: {out[label]['phase_s']:.1f} s", flush=True)
    out["failed"] = cs.FAILED
    out["seconds"] = time.perf_counter() - t0
    (dest / "records.json").write_text(json.dumps(out, indent=1,
                                                  default=str))
    print(f"check_flash_wide: {len(records)} records, "
          f"{out['seconds']:.1f} s; failed expects: {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
