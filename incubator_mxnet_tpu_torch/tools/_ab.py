"""What the A/B tools of this directory share: running each side of an A/B
in a process of its own, in alternating order, importing one checkout each,
timing kernels from whole profiler traces, and the report.

A tool defines ``run_side(root) -> dict`` (the measurements of one side,
which must hold "card"), ``metrics(result) -> {name: value}`` and
optionally ``notes(runs)`` (lines printed after the table), and calls
:func:`main`. ``--report <ab.json>`` prints a finished run's report again
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ITERS, TRIES = 20, 4


def import_root(root):
    """Import ``chip_smoke`` and ``incubator_mxnet_tpu_torch`` from the
    checkout at `root` and from nowhere else; returns both modules."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("A/B: no CUDA device")
    import chip_smoke as cs
    import incubator_mxnet_tpu_torch as port
    for mod in (cs, port):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"A/B: {mod.__name__} came from "
                             f"{mod.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cs, port


def trace_ms(fn, whole, iters=ITERS, tries=TRIES):
    """(device ms per call of `fn`, short traces): the profiler's device
    time of every kernel `iters` calls launched, from the first trace that
    `whole` accepts. ``whole({kernel name: events})`` says whether a trace
    holds all the calls' work (the profiler now and then drops events); a
    trace it refuses is counted and taken again, `tries` times at most,
    after which the time is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    short = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, counts = 0.0, {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                ms += e.self_device_time_total / iters / 1e3
                counts[e.key] = counts.get(e.key, 0) + e.count
        if counts and whole(counts):
            return ms, short
        short += 1
    return None, short


def quartiles(values):
    """(lower quartile, median, upper quartile) of `values`: the sorted
    values at n // 4 and 3n // 4, and the median."""
    import statistics
    v = sorted(values)
    return v[len(v) // 4], statistics.median(v), v[(3 * len(v)) // 4]


def rounds_lower(runs, name, labels):
    """(rounds in which labels[1]'s value of `name` is lower than
    labels[0]'s, rounds): a round is two runs in a row, one of each side,
    as :func:`main` orders them; a round with a null value counts for
    neither."""
    pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs) - 1, 2)]
    lower = sum(1 for p in pairs
                if None not in (p[labels[0]][name], p[labels[1]][name])
                and p[labels[1]][name] < p[labels[0]][name])
    return lower, len(pairs)


def report(runs, metrics, notes=None):
    """Per measurement: every run's value in run order, each side's
    quartiles and, with two sides, in how many rounds the second read
    lower than the first. `runs` is [(label, result)] in run order."""
    print(runs[0][1]["card"])
    labels = list(dict.fromkeys(label for label, _ in runs))
    print("runs in order: " + " ".join(label for label, _ in runs))
    table = [(label, metrics(r)) for label, r in runs]
    for name in table[0][1]:
        line = [f"{name}:"]
        for label in labels:
            v = [m[name] for lab, m in table if lab == label]
            line.append(f"{label} " + ", ".join(
                "null" if x is None else f"{x:.5g}" for x in v))
            if None not in v:
                line.append(f"{label} quartiles " + "/".join(
                    f"{x:.5g}" for x in quartiles(v)))
        if len(labels) == 2:
            lower, n = rounds_lower(table, name, labels)
            line.append(f"{labels[1]} lower in {lower} of {n}")
        print(" | ".join(line))
    for text in (notes(runs) if notes else ()):
        print(text)


def main(argv, doc, script, run_side, metrics, notes=None,
         default_out="chiprun_out/ab"):
    """The command line of an A/B tool (see the tool's docstring)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("sides", nargs="*", help="label=root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=default_out)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    ap.add_argument("--report", metavar="AB_JSON",
                    help="print the report of an earlier run's ab.json")
    args = ap.parse_args(argv)
    if args.report:
        report([(r.pop("label"), r) for r in json.loads(
            Path(args.report).read_text())], metrics, notes)
        return 0
    if args.side:
        Path(args.json).write_text(json.dumps(run_side(args.side), indent=1))
        return 0
    sides = [s.split("=", 1) for s in args.sides]
    if len(sides) < 2 or any(len(s) != 2 for s in sides):
        ap.error("give two or more sides as label=root")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for r in range(args.rounds):
        for label, root in (sides if r % 2 == 0 else sides[::-1]):
            i = len(runs)
            js = out / f"{i}_{label}.json"
            with open(out / f"{i}_{label}.log", "w") as log:
                t = time.perf_counter()
                rc = subprocess.run(
                    [sys.executable, str(Path(script).resolve()),
                     "--side", root, "--json", str(js)],
                    stdout=log, stderr=subprocess.STDOUT, timeout=1200,
                    check=False).returncode
            if rc != 0:
                print((out / f"{i}_{label}.log").read_text()[-4000:])
                print(f"A/B: side {label} ({root}) exited {rc}")
                return 1
            runs.append((label, json.loads(js.read_text())))
            print(f"run {i}: {label} in {time.perf_counter() - t:.0f} s",
                  flush=True)
    report(runs, metrics, notes)
    (out / "ab.json").write_text(json.dumps(
        [{"label": label, **r} for label, r in runs], indent=1))
    return 0
