#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: the flash-attention
backward kernels at GPT-2-base's training shape, and chip_smoke's GPT-2-base
training step.

    python3 incubator_mxnet_tpu_torch/tools/ab_flash.py \\
        pr5=scratch_tree/pr5 new=. [--rounds 2] [--out chiprun_out/ab_flash]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a parent
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only, builds that root's kernels,
and measures with this script's code (``_ab``), so that every side is timed
with the same yardstick. The sides run in order and then in reverse,
``--rounds`` times in all (A, B, B, A for two sides and two rounds).

A side measures, with TF32 off, at (B, H, L, D) = (8, 12, 512, 64), causal,
q, k and v cut out of one (B, L, 3HD) projection and dO a (B, H, L, D) view
of a (B, L, H, D) buffer, as training hands them over, in f32 and bf16:

* first, the root's own ``chip_smoke.check_flash_bwd``: every backward
  case against the plain versions (the side stops if one is off), whose
  worst error per dtype the report prints;
* the dQ kernel (``flash_attention_bwd_dq``), the dK/dV kernel
  (``flash_attention_bwd_dkv``) and the whole backward
  (``flash_attention_bwd``: delta, dQ, dK/dV): their device time per call
  from ``torch.profiler`` over 20 calls. A trace is kept only if every
  kernel in it ran a whole multiple of 20 times and each of the root's
  backward kernels exactly 20 times a launch; a short trace is counted and
  taken again, four times at most, after which the time is null;
* SDPA's backward (``torch.autograd.grad`` of
  ``scaled_dot_product_attention``) on the same inputs, the yardstick, with
  the names of the kernels it launches;
* the root's own ``chip_smoke.train_lm`` (GPT-2-base, 30 Adam steps at
  batch 8 x 512, every check that phase makes): the median step, its
  phases, its device time by kind of kernel;
* the compiler's registers, spills and stack frames of the root's
  backward kernels (``nvcc -Xptxas -v``).

The script writes each side's JSON and log and ``ab.json`` under ``--out``
and prints one line per measurement: every run's value in run order, each
side's quartiles and, with two sides, in how many rounds the second read
lower. ``--report <ab.json>`` prints that report again, without a card.
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

if __package__:
    from . import _ab
else:                # run as a script: its directory is on sys.path
    import _ab

SHAPE = (8, 12, 512, 64)                 # B, H, L, D of the LM's attention
OURS = {"dq": ("flash_bwd_dq_kernel",), "dkv": ("flash_bwd_dkv_kernel",),
        "whole": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
        "sdpa": ()}


def _whole(ours):
    """A trace holds all the calls' work: every kernel a whole multiple of
    the calls, and each kernel named in `ours` once a call."""
    def whole(counts):
        if any(n % _ab.ITERS for n in counts.values()):
            return False
        return all(sum(n for k, n in counts.items() if name in k)
                   == _ab.ITERS for name in ours)
    return whole


def _names(fn):
    """The kernels one call of `fn` launches (one profiler trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def time_flash(fa):
    """Every (kernel, dtype) record of the side: device ms a call."""
    import torch
    import torch.nn.functional as F
    b, h, length, d = SHAPE
    kw = dict(causal=True, scale=1.0 / math.sqrt(d))
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = []
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                          device="cuda").to(tdt)
        q, k, v = (t.reshape(b, length, h, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        do = torch.randn(b, length, h, d, generator=gen, device="cuda").to(
            tdt).permute(0, 2, 1, 3)
        out, lse = fa.flash_attention_ref(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               scale=kw["scale"])
        calls = {
            "dq": lambda: fa.flash_attention_bwd_dq(*args, **kw),
            "dkv": lambda: fa.flash_attention_bwd_dkv(*args, **kw),
            "whole": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                    **kw),
            "sdpa": lambda: torch.autograd.grad(o_lib, leaves, do,
                                                retain_graph=True)}
        for name, fn in calls.items():
            rec = dict(kernel=name, dtype=dtype, shape=list(SHAPE),
                       causal=True)
            rec["ms"], rec["short_traces"] = _ab.trace_ms(
                fn, _whole(OURS[name]))
            rec["kernels"] = _names(fn)
            records.append(rec)
            print(f"{name} {dtype}: ms {rec['ms']}", flush=True)
    return records


def run_side(root):
    """One side: the root's package and chip_smoke, this script's
    measurements."""
    cs, _ = _ab.import_root(root)
    import torch
    from incubator_mxnet_tpu_torch.ops.cuda import _build
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    t0 = time.perf_counter()
    build_s = _build.build(("flash_attention", "flash_attention_bwd",
                            "layer_norm"))
    ptxas = [line.strip() for line in
             _build.logs().get("flash_attention_bwd", "").splitlines()
             if any(s in line for s in ("entry function", "spill", "Used"))]
    print("\n".join(ptxas), flush=True)
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
              "ptxas": ptxas}
    checked = []
    cs.check_flash_bwd(checked)
    result["check_worst"] = {
        dt: max(r["max_abs_err"] for r in checked if r["dtype"] == dt)
        for dt in ("float32", "bfloat16")}
    result["flash"] = time_flash(fa)
    torch.cuda.empty_cache()
    step = cs.train_lm({}, cs.LM)
    result["step"] = {k: step[k] for k in (
        "step_ms_median", "forward_ms_median", "backward_ms_median",
        "optimizer_ms_median", "tokens_per_s", "step_device_ms",
        "step_stream_ms", "idle_share", "step_by_kind_ms",
        "launches_per_step", "step0_grad_worst")}
    return result


def metrics(result):
    """{name: value} of one side's run."""
    m = {f"{r['kernel']} {r['dtype']} ms": r["ms"] for r in result["flash"]}
    step = result["step"]
    for key in ("step_ms_median", "forward_ms_median", "backward_ms_median",
                "tokens_per_s", "step_device_ms"):
        m[f"step {key}"] = step[key]
    kinds = step["step_by_kind_ms"]
    m["step flash backward device ms"] = (kinds.get("flash_bwd_dq", 0.0)
                                          + kinds.get("flash_bwd_dkv", 0.0))
    return m


def notes(runs):
    """Short traces, the checks, SDPA's kernels and the compiler's
    registers and spills, side by side."""
    short = sum(r["short_traces"] for _, res in runs for r in res["flash"])
    total = sum(len(res["flash"]) for _, res in runs)
    yield f"short traces: {short} (of {total} times)"
    for label, res in dict(runs).items():
        worst = {dt: max(rs["check_worst"][dt] for lab, rs in runs
                         if lab == label) for dt in ("float32", "bfloat16")}
        yield (f"{label}: chip_smoke.check_flash_bwd passed in every run; "
               f"worst error against the plain versions {worst}")
        sdpa = {r["dtype"]: r["kernels"] for r in res["flash"]
                if r["kernel"] == "sdpa"}
        yield f"{label}: SDPA's backward launches {sdpa}"
        for line in res["ptxas"]:
            yield f"{label} ptxas: {line}"


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics, notes,
                    default_out="chiprun_out/ab_flash")


if __name__ == "__main__":
    sys.exit(main())
