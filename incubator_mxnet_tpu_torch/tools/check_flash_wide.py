#!/usr/bin/env python3
"""The head-dim-above-256 checks of ``chip_smoke.py`` alone, on one card.

    python3 incubator_mxnet_tpu_torch/tools/check_flash_wide.py \\
        [--train] [--autograd] [--root DIR] [--dtypes float32,bfloat16]
        [--cases d512_l512,...] [--out chiprun_out/check_flash_wide]

Builds the two flash sources (printing what ``nvcc -Xptxas -v`` says of
the kernels above head dim 256: registers, spills, stack; the 16-bit dQ and
dK/dV's ``flash_bwd_dq_wide_wgmma_kernel`` and
``flash_bwd_dkv_wide_wgmma_kernel`` once more on lines of their own),
then runs ``chip_smoke.flash_wide``: every wide kernel against its plain
version at every case of ``chip_smoke.wide_cases()`` and D = 257 through
the padding Function, in f32 also against the plain version in float64,
two calls for the same bits, every launch traced to the kernel of its
dtype, and at ``chip_smoke.WIDE_TIMED`` each timed (``torch.profiler``
device time) against its bound, its plain version and SDPA, whose backend
is named. With ``--train`` it then runs chip_smoke's train_lm_d512_bf16
and train_lm_d512_f32 phases (``train_lm_fused`` at ``chip_smoke.LM_D512``)
with every check they make; with ``--autograd`` its autograd_api phase.
``--root`` runs the ``chip_smoke`` and the package of another checkout (a
``git archive`` of a parent commit, unpacked), so that a parent's kernels
give the numbers to compare with on the same card; several runs in one
call, parent and change in turns, bracket a change. ``--dtypes`` and
``--cases`` keep those dtypes and ``wide_cases()`` names only (the padded
D = 257 call and the ``--train`` phases run in the kept dtypes). It
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
# the kernels this tool prints ptxas's lines for on lines of their own
NEW = ("flash_bwd_dq_wide_wgmma_kernel", "flash_bwd_dkv_wide_wgmma_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--autograd", action="store_true")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--dtypes", default="float32,bfloat16,float16")
    ap.add_argument("--cases", default="")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "check_flash_wide"))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_wide: no CUDA device")
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    if root not in Path(cs.__file__).resolve().parents:
        raise SystemExit(f"check_flash_wide: chip_smoke came from "
                         f"{cs.__file__}, not from {root}")

    t0 = time.perf_counter()
    print(cs.gpu_name_and_limit(), flush=True)
    print(f"root: {root}", flush=True)
    print("build:", _build.build(("flash_attention", "flash_attention_bwd")),
          flush=True)
    dest = Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    ptxas = [f"{name}: {line.strip()}"
             for name, text in _build.logs().items()
             for line in text.splitlines()
             if any(w in line for w in ("registers", "spill", "stack",
                                        "Compiling entry", "serialized"))]
    (dest / "ptxas.txt").write_text("\n".join(ptxas) + "\n")
    # each wide kernel's entry line and the lines after it
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and "wide" in line:
            new = any(n in line for n in NEW)
            for text in ptxas[i:i + 4]:
                print(("  new kernel: " if new else "  ptxas ") + text,
                      flush=True)
    # ptxas's note where it serializes a kernel's wgmma
    for line in ptxas:
        if "serialized" in line:
            print("  ptxas " + line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cs.FLASH_TOLS = tuple(t for t in cs.FLASH_TOLS
                          if t[0] in args.dtypes.split(","))
    if args.cases:
        keep = args.cases.split(",")
        cases = cs.wide_cases
        cs.wide_cases = lambda: [c for c in cases() if c[0] in keep]
    records = []
    out = {"card": cs.gpu_name_and_limit(), "root": str(root),
           "records": records}
    t = time.perf_counter()
    cs.flash_wide(records)
    out["flash_wide_s"] = time.perf_counter() - t
    print(f"flash_wide: {out['flash_wide_s']:.1f} s", flush=True)
    phases = []
    if args.train:
        phases += [(label, lambda dtype=dtype, label=label: cs.train_lm_fused(
            {}, dtype=dtype, label=label, **cs.LM_D512))
            for dtype, label in (("bfloat16", "train_lm_d512_bf16"),
                                 ("float32", "train_lm_d512_f32"))
            if dtype in args.dtypes.split(",")]
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
