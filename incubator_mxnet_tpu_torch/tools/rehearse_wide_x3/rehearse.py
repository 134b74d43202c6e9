#!/usr/bin/env python3
"""Rehearse the split-TF32 wide flash backward on the CPU, without a card.

    python3 incubator_mxnet_tpu_torch/tools/rehearse_wide_x3/rehearse.py \\
        [--cases "B H lq lk D causal kv_len seed;..."] [--no-trunc]
        [--par 2] [--build DIR]

Builds one host C++20 file from the repository's sources (common.cuh's
``Swizzled`` and ``stage``, hopper.cuh's ``split_tf32``, and
flash_attention_wide.cu's ``Args`` and its split-TF32 part, from
``constexpr int kW`` to ``launch_x3``, with ``extern __shared__`` made a
pointer), with ``shim.h`` standing in for CUDA and ``driver.h`` running
``flash_bwd_dq_wide_tf32x3_kernel``'s and
``flash_bwd_dkv_wide_tf32x3_kernel``'s body on host threads; compiles it
with ``g++ -std=c++20 -O2 -pthread`` and runs each case. Each case prints
dQ's, dK's and dV's largest error against float64 beside a plain f32
loop's; the script exits 1 if any output has a non-finite value or an
error over 1e-4 of the largest value. It finds indexing, staging and
masking faults and shows the order of sums' rounding (``--no-trunc``:
the tensor cores' sums rounded to nearest, not cut toward zero); it does
not see races, bank conflicts, registers, or names that only the whole
file's namespace hides. A case takes seconds to a minute (512 threads a
block).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parents[1] / "ops" / "cuda" / "csrc"
# B H lq lk D causal kv_len seed: ragged causal at D = 320 and 384, lq
# above and below lk, kv_len cut mid-tile and 0, D = 512, two batches
CASES = ("1 1 100 100 320 1 100 0; 1 2 70 130 384 1 97 1; "
         "1 1 64 64 512 0 50 2; 1 1 64 64 384 1 0 3; 2 1 130 90 320 1 90 4")


def source() -> str:
    """The translation unit: the shim, the kernels' code as the repository
    has it, the driver."""
    common = (CSRC / "common.cuh").read_text()
    hopper = (CSRC / "hopper.cuh").read_text()
    wide = (CSRC / "flash_attention_wide.cu").read_text()
    tiles = common[common.index("constexpr float kLog2e"):
                   common.index("// A warp's lanes form a grid")]
    split = re.search(r"__device__ __forceinline__ void split_tf32.*?\n}\n",
                      hopper, re.S).group(0)
    args = re.search(r"struct Args \{.*?\n\};\n", wide, re.S).group(0)
    body = wide[wide.index("constexpr int kW = 64;"):
                wide.index("// f32: a split-TF32 kernel on the grid")]
    body = body.replace(
        "extern __shared__ __align__(128) unsigned char wx_smem[];",
        "unsigned char* const wx_smem = g_smem;")
    return "\n".join(['#include "shim.h"', "namespace mxt {", tiles, split,
                      "namespace wide {", args, body, "}  // namespace wide",
                      "}  // namespace mxt", '#include "driver.h"'])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--no-trunc", action="store_true")
    ap.add_argument("--par", type=int, default=2)
    ap.add_argument("--build", default=None)
    args = ap.parse_args()
    build = Path(args.build or tempfile.mkdtemp(prefix="rehearse_wide_x3_"))
    build.mkdir(parents=True, exist_ok=True)
    cpp, exe = build / "x3wide.cpp", build / "x3wide"
    cpp.write_text(source())
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", f"-I{HERE}",
                    *(["-DNO_TRUNC"] if args.no_trunc else []),
                    "-o", str(exe), str(cpp)], check=True)
    bad = 0
    for case in args.cases.split(";"):
        words = case.split()
        print(f"case B H lq lk D causal kv_len seed = {' '.join(words)}",
              flush=True)
        bad += subprocess.run([str(exe), *words, str(args.par)]).returncode != 0
    print(f"rehearse_wide_x3: {bad} case(s) failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
