#!/usr/bin/env python3
"""Time every plan of the bf16 wgmma GEMM at ResNet-50's 1x1 shapes, on one
card: the evidence behind ``mm_plan``'s bf16 rule.

    python3 incubator_mxnet_tpu_torch/tools/sweep_mm_plans.py \\
        [--out chiprun_out/sweep_mm_plans]

For each shape (the nine 1x1/stride-1 convs of ResNet-50 at bucket 32, and
the ones whose plan splits K at buckets 1 and 4) it runs the GEMM through
``_mm_epilogue_with_plan`` on the wgmma route under every tile of
``MM_WGMMA_TILES`` and every split of 1, 2, 3, 4 and 8 that gives as many
K ranges, holds each against the plain version (2e-2 of the value, as
chip_smoke's checks do), and times it as a served forward runs it: 20
calls captured in one CUDA graph, the graph replayed 5 times between two
CUDA events, so that no host time lies between the kernels (a call's
time is its GEMM and, for a split plan, its reduce kernel, and the gap
between launches in a graph). It prints one line per shape with every
plan's time, the plan ``mm_plan`` picks and its rank, and cuBLAS's
``torch._addmm_activation`` (``torch.addmm`` without an activation)
beside them, and writes the records to ``<out>/sweep.json``. The card's
name and power limit head the output.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (name, pixels per image, K, N, act, buckets)
SHAPES = [("s1_conv1_first", 56 * 56, 64, 64, "relu", (32,)),
          ("s1_conv3_ds", 56 * 56, 64, 256, None, (32,)),
          ("s1_conv1", 56 * 56, 256, 64, "relu", (32,)),
          ("s2_conv3", 28 * 28, 128, 512, None, (32,)),
          ("s2_conv1", 28 * 28, 512, 128, "relu", (32, 4)),
          ("s3_conv3", 14 * 14, 256, 1024, None, (32,)),
          ("s3_conv1", 14 * 14, 1024, 256, "relu", (32, 4, 1)),
          ("s4_conv3", 7 * 7, 512, 2048, None, (32, 4)),
          ("s4_conv1", 7 * 7, 2048, 512, "relu", (32, 4, 1))]
SPLITS = (1, 2, 3, 4, 8)
CALLS, REPLAYS = 20, 5


def graph_ms(fn):
    """ms per call of `fn`: CALLS calls captured in one CUDA graph (after
    an eager call and one on the capture's stream), replayed REPLAYS times
    back to back between two events (after one replay to warm)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (CALLS * REPLAYS)


def sweep():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import conv_bn_relu as cbr
    if not torch.cuda.is_available():
        raise SystemExit("sweep_mm_plans: no CUDA device")
    print(cs.gpu_name_and_limit(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tdt = torch.bfloat16
    out = []
    for name, pixels, k, n, act, buckets in SHAPES:
        for bucket in buckets:
            m = bucket * pixels
            x = torch.randn(m, k, generator=gen, device="cuda").to(tdt)
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 / math.sqrt(k)).to(tdt)
            s = torch.rand(n, generator=gen, device="cuda") + 0.5
            b = torch.randn(n, generator=gen, device="cuda")
            ref = cbr.mm_epilogue_ref(x, w, s, b, act).float()
            times = {}
            for tile in cbr.MM_WGMMA_TILES:
                for split in SPLITS:
                    if len(cbr.mm_ranges(k, split, tdt)) != split:
                        continue
                    plan = (tile, split)

                    def call(plan=plan):
                        return cbr._mm_epilogue_with_plan(x, w, s, b, act,
                                                          plan, "wgmma")
                    y = call().float()
                    torch.cuda.synchronize()
                    if not torch.allclose(y, ref, rtol=2e-2, atol=2e-2):
                        raise SystemExit(f"sweep_mm_plans: {name} b{bucket} "
                                         f"{plan} disagrees with the plain "
                                         f"version")
                    times[f"{tile[0]}x{tile[1]}/{split}"] = graph_ms(call)
            ws, bl = (w.float() * s).to(tdt), b.to(tdt)
            lib = ((lambda: torch._addmm_activation(bl, x, ws))
                   if act == "relu" else (lambda: torch.addmm(bl, x, ws)))
            lib_ms = graph_ms(lib)
            (bm, bn), split = cbr.mm_plan(m, n, k, tdt)
            chosen = f"{bm}x{bn}/{split}"
            ranked = sorted((t, p) for p, t in times.items())
            rank = [p for _, p in ranked].index(chosen) + 1
            rec = dict(case=f"{name}_b{bucket}", shape=[m, k, n],
                       times_ms=times, chosen=chosen, chosen_rank=rank,
                       best=ranked[0][1], library_ms=lib_ms)
            out.append(rec)
            print(f"{rec['case']:18s} {m}x{k}x{n}: chosen {chosen} "
                  f"(rank {rank}) {times[chosen]:.4f} ms, best "
                  f"{ranked[0][1]} {ranked[0][0]:.4f}, cuBLAS {lib_ms:.4f}; "
                  + ", ".join(f"{p} {t:.4f}" for t, p in ranked), flush=True)
    print(cs.gpu_name_and_limit(), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/sweep_mm_plans")
    args = ap.parse_args(argv)
    records = sweep()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "sweep.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
