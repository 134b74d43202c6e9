#!/usr/bin/env python3
"""The head-dim-256 flash checks of ``chip_smoke.py`` alone, on one card.

    python3 incubator_mxnet_tpu_torch/tools/check_flash_d256.py \\
        [--train] [--sass] [--dtypes float32,bfloat16,float16] [--root DIR]
        [--out chiprun_out/check_flash_d256]

Builds the two flash sources (printing what ``nvcc -Xptxas -v`` says of
each kernel: registers, spills, stack; the f32 split-TF32 kernels at
D = 256, ``flash_fwd_tf32x3_kernel``, ``flash_bwd_dq_tf32x3_kernel`` and
``flash_bwd_dkv_tf32x3_kernel``, once more on lines of their own), then
runs ``chip_smoke.check_flash`` and ``chip_smoke.check_flash_bwd`` on the
head-dim-256 cases and the padded D = 192 case only, in f32, bf16 and f16:
every kernel against its plain version (in f32 at D = 256 and 192 also
against the plain version in float64), two calls for the same bits, every
launch traced to the kernel its dtype takes, and each timed
(``torch.profiler`` device time) against its bound, its plain version and
SDPA. With ``--train`` it then runs chip_smoke's
train_lm_d256_bf16 and train_lm_d256_f32 phases (``train_lm_fused`` at
``chip_smoke.LM_D256`` in bf16 and in f32) with every check those phases
make. ``--root`` runs the ``chip_smoke`` and the package of another
checkout (a ``git archive`` of a parent commit, unpacked), so that a
parent's kernels give the numbers to compare with; the f32 phase then runs
through that checkout's ``train_lm_fused``. It prints one line per record
and writes them all to ``--out``/records.json, and ptxas's lines to
``--out``/ptxas.txt. ``--sass`` also counts the instructions of the
split-TF32 kernels' machine code (``cuobjdump -sass`` of the built
libraries, by opcode) into ``--out``/sass.txt and prints the commonest.
``--dtypes`` runs the kernel checks in those dtypes only.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the kernels this tool prints ptxas's lines for on lines of their own
NEW = ("tf32x3",)


def sass_counts(build, dest):
    """Opcode counts of each split-TF32 kernel in the built flash
    libraries, from ``cuobjdump -sass`` (next to nvcc)."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = "".join(
        subprocess.run([str(tool), "-sass", str(build._target(src))],
                       capture_output=True, text=True, check=True).stdout
        for src in ("flash_attention", "flash_attention_bwd"))
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(n in name for n in NEW) else None
            if name:
                counts[name] = collections.Counter()
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[name][m.group(1).split(".")[0]] += 1
    lines = []
    for name, c in counts.items():
        lines.append(f"{name}: {sum(c.values())} instructions")
        lines += [f"  {op} {n}" for op, n in c.most_common()]
    (dest / "sass.txt").write_text("\n".join(lines) + "\n")
    for name, c in counts.items():
        print(f"  sass {name}: {sum(c.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in c.most_common(14)),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--dtypes", default="float32,bfloat16,float16")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "check_flash_d256"))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_d256: no CUDA device")
    import chip_smoke as cs
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    if root not in Path(cs.__file__).resolve().parents:
        raise SystemExit(f"check_flash_d256: chip_smoke came from "
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
                                        "Compiling entry"))]
    (dest / "ptxas.txt").write_text("\n".join(ptxas) + "\n")
    for line in ptxas:
        print("  ptxas " + line, flush=True)
    # each new kernel's entry line and the register and spill lines after it
    for i, line in enumerate(ptxas):
        if "Compiling entry" in line and any(n in line for n in NEW):
            for text in ptxas[i:i + 4]:
                print("  new kernel: " + text, flush=True)
    if args.sass:
        sass_counts(_build, dest)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    fwd, bwd = cs.flash_cases, cs.flash_bwd_cases
    cs.flash_cases = lambda: [c for c in fwd() if c[5] == 256]
    cs.flash_bwd_cases = lambda: [c for c in bwd() if c[5] == 256]
    cs.PADDED_CASES = tuple(c for c in cs.PADDED_CASES if c[3] > 128)
    cs.FLASH_TOLS = tuple(t for t in cs.FLASH_TOLS
                          if t[0] in args.dtypes.split(","))
    records = []
    cs.check_flash(records)
    cs.check_flash_bwd(records)
    out = {"card": cs.gpu_name_and_limit(), "root": str(root),
           "records": records}
    if args.train:
        for dtype, label in (("bfloat16", "train_lm_d256_bf16"),
                             ("float32", "train_lm_d256_f32")):
            t = time.perf_counter()
            out[label] = cs.train_lm_fused({}, dtype=dtype, label=label,
                                           **cs.LM_D256)
            out[label]["phase_s"] = time.perf_counter() - t
            print(f"{label}: {out[label]['phase_s']:.1f} s", flush=True)
    out["failed"] = cs.FAILED
    out["seconds"] = time.perf_counter() - t0
    (dest / "records.json").write_text(json.dumps(out, indent=1,
                                                  default=str))
    print(f"check_flash_d256: {len(records)} records, "
          f"{out['seconds']:.1f} s; failed expects: {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
