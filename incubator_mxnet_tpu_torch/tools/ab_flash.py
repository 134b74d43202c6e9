#!/usr/bin/env python3
"""A/B of two or more checkouts of the port on one card: the flash-attention
forward kernel at BERT's serving shape and GPT-2-base's training shape, the
backward kernels at the training shape, and chip_smoke's GPT-2-base
training step.

    python3 incubator_mxnet_tpu_torch/tools/ab_flash.py \\
        parent=scratch_tree/parent new=. [--rounds 2] \\
        [--out chiprun_out/ab_flash]

Each argument is ``label=root``, where root holds ``chip_smoke.py`` and
``incubator_mxnet_tpu_torch/`` (for instance a ``git archive`` of a parent
commit, unpacked). Every side runs in a process of its own that imports the
package and ``chip_smoke`` of its root only, builds that root's kernels,
and measures with this script's code (``_ab``), so that every side is timed
with the same yardstick. The sides run in order and then in reverse,
``--rounds`` times in all (A, B, B, A for two sides and two rounds).

A side measures, with TF32 off, q, k and v cut out of one (B, L, 3HD)
projection and dO a (B, H, L, D) view of a (B, L, H, D) buffer, as the
model hands them over, in f32 and bf16:

* first, the root's own ``chip_smoke.check_flash`` and
  ``chip_smoke.check_flash_bwd``: every forward and backward case against
  the plain versions (the side stops if one is off), whose worst error per
  dtype the report prints;
* the forward kernel (``flash_attention_fwd``) at BERT's bucket 8,
  (B, H, L, D) = (8, 12, 128, 64), and at the LM's (8, 12, 512, 64),
  causal (``fwd_bert_b8``, ``fwd_lm``), with SDPA's forward
  (``scaled_dot_product_attention``) on the same inputs beside each
  (``sdpa_fwd_bert_b8``, ``sdpa_fwd_lm``);
* at the LM's shape, the dQ kernel (``flash_attention_bwd_dq``), the dK/dV
  kernel (``flash_attention_bwd_dkv``) and the whole backward
  (``flash_attention_bwd``: delta, dQ, dK/dV), and SDPA's backward
  (``torch.autograd.grad`` of ``scaled_dot_product_attention``);
* every time is device time per call from ``torch.profiler`` over 20
  calls. A trace is kept only if every kernel in it ran a whole multiple of
  20 times and each of the root's kernels exactly 20 times a launch; a
  short trace is counted and taken again, four times at most, after which
  the time is null. The kernels each library call launches are recorded;
* the root's own ``chip_smoke.train_lm`` (GPT-2-base, 30 Adam steps at
  batch 8 x 512, every check that phase makes): the median step, its
  phases, its device time by kind of kernel;
* the compiler's registers, spills and stack frames of the root's flash
  kernels (``nvcc -Xptxas -v``).

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
FWD_SHAPES = {"bert_b8": ((8, 12, 128, 64), False), "lm": (SHAPE, True)}
# the root's kernels a call launches once, each named by a prefix that
# covers both of its forms: "flash_fwd" flash_fwd_kernel and, for bf16 where
# the root has it, flash_fwd_wgmma_kernel; "flash_bwd_dq" flash_bwd_dq_kernel
# and flash_bwd_dq_wgmma_kernel; "flash_bwd_dkv" likewise
OURS = {"dq": ("flash_bwd_dq",), "dkv": ("flash_bwd_dkv",),
        "whole": ("flash_bwd_dq", "flash_bwd_dkv"),
        "sdpa": (), "fwd": ("flash_fwd",), "sdpa_fwd": ()}


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


def _qkv(shape, tdt, gen):
    """q, k, v as (B, H, L, D) views of one (B, L, 3HD) projection."""
    import torch
    b, h, length, d = shape
    qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                      device="cuda").to(tdt)
    return [t.reshape(b, length, h, d).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)]


def _time(records, name, fn, ours, **rec):
    """Append `fn`'s record: device ms a call, short traces, the kernels it
    launches; `ours` names the root's kernels one call launches once."""
    rec = dict(kernel=name, **rec)
    rec["ms"], rec["short_traces"] = _ab.trace_ms(fn, _whole(ours))
    rec["kernels"] = _names(fn)
    records.append(rec)
    print(f"{name} {rec['dtype']}: ms {rec['ms']}", flush=True)


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
        for case, (shape, causal) in FWD_SHAPES.items():
            q, k, v = _qkv(shape, tdt, gen)
            fkw = dict(causal=causal, scale=1.0 / math.sqrt(shape[3]))
            for name, fn in (
                    ("fwd", lambda: fa.flash_attention_fwd(q, k, v, **fkw)),
                    ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, scale=fkw["scale"]))):
                _time(records, f"{name}_{case}", fn, OURS[name],
                      dtype=dtype, shape=list(shape), causal=causal)
        q, k, v = _qkv(SHAPE, tdt, gen)
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
            _time(records, name, fn, OURS[name], dtype=dtype,
                  shape=list(SHAPE), causal=True)
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
    logs = _build.logs()
    ptxas = [line.strip() for name in ("flash_attention",
                                       "flash_attention_bwd")
             for line in logs.get(name, "").splitlines()
             if any(s in line for s in ("entry function", "spill", "Used"))]
    print("\n".join(ptxas), flush=True)
    result = {"root": str(Path(root).resolve()),
              "card": cs.gpu_name_and_limit(), "torch": torch.__version__,
              "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
              "ptxas": ptxas}
    fwd, bwd = [], []
    cs.check_flash(fwd)
    cs.check_flash_bwd(bwd)
    for key, checked in (("check_fwd_worst", fwd), ("check_worst", bwd)):
        result[key] = {
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
    m["step flash forward device ms"] = kinds.get("flash_attention", 0.0)
    return m


def notes(runs):
    """Short traces, the checks, SDPA's kernels and the compiler's
    registers and spills, side by side."""
    short = sum(r["short_traces"] for _, res in runs for r in res["flash"])
    total = sum(len(res["flash"]) for _, res in runs)
    yield f"short traces: {short} (of {total} times)"
    for label, res in dict(runs).items():
        for key, check in (("check_fwd_worst", "check_flash"),
                           ("check_worst", "check_flash_bwd")):
            worst = {dt: max(rs[key][dt] for lab, rs in runs
                             if lab == label)
                     for dt in ("float32", "bfloat16")}
            yield (f"{label}: chip_smoke.{check} passed in every run; "
                   f"worst error against the plain versions {worst}")
        for sdpa, what in (("sdpa_fwd_lm", "forward"), ("sdpa", "backward")):
            kernels = {r["dtype"]: r["kernels"] for r in res["flash"]
                       if r["kernel"] == sdpa}
            yield f"{label}: SDPA's {what} launches {kernels}"
        for line in res["ptxas"]:
            yield f"{label} ptxas: {line}"


def main(argv=None):
    return _ab.main(argv, __doc__, __file__, run_side, metrics, notes,
                    default_out="chiprun_out/ab_flash")


if __name__ == "__main__":
    sys.exit(main())
